// Merge of two ascending u64 arrays: the prepared join's merged operand.
//
// Replaces the TPU kernel dj_tpu/ops/pallas_merge.py::merge_sorted_u64
// (merge_splits, _make_merge_kernel, _bitonic_merge_planes). For a of
// length R and b of length L, both ascending as unsigned 64-bit words,
// out is the (R + L,) ascending union, bit-identical to an unsigned sort
// of concat(a, b). The port holds the words as int64 bit patterns; this
// kernel reads them as unsigned long long, so the all-ones padding (-1 as
// int64) is the largest word, as on the TPU.
//
// Bound on this card: bytes. Each input word is read once and each
// output word written once, 16 B per merged word; the work per word is a
// few compares. At R = L = 100M that is 3.2 GB, about 0.96 ms at the
// memory rate of an H100 SXM.
//
// Design: a merge-path merge. The TPU kernel bitonic-merges each tile in
// registers because a TPU core cannot gather from its vector memory;
// Hopper can, so each thread merges sequentially.
//   1. splits: one thread per tile boundary k = p * TILE binary-searches
//      the diagonal for ia[p] = #a-words among the first k merged words
//      (the A-first tie rule of merge_splits: the largest i with
//      a[i-1] <= b[k-i]). All searches run at once, so the pass costs
//      one search's latency.
//   2. merge: block p owns merged words [p*TILE, (p+1)*TILE). Its
//      windows a[ia[p], ia[p+1]) and b[k0 - ia[p], k1 - ia[p+1]) hold
//      exactly the tile's words, so they are bounded by TILE on every
//      input and need no fallback. The block stages both windows in
//      shared memory (coalesced), each thread finds its own sub-split by
//      the same search and merges IPT words in order, the results go
//      back through shared memory (one pad word every 32 spreads the
//      banks), and the tile is written out coalesced.
// Ties take a first everywhere; since equal words are identical bits,
// any consistent rule gives the same output.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int MT = 256;                       // threads per block
constexpr int IPT = 16;                       // merged words per thread
constexpr int TILE = MT * IPT;                // merged words per block
constexpr int PADDED = TILE + TILE / 32;      // staged words with bank pads
constexpr u64 ONES = ~0ULL;

__device__ __forceinline__ int pad(int w) { return w + (w >> 5); }

__global__ void merge_splits_kernel(const u64* a, const u64* b, long long R,
                                    long long L, long long P, int* splits) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p > P) return;
  const long long k = min(p * TILE, R + L);
  long long lo = max(k - L, 0LL), hi = min(k, R);
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    const long long bi = k - mid;
    const u64 bv = bi < L ? b[bi] : ONES;
    if (a[mid - 1] <= bv) lo = mid; else hi = mid - 1;
  }
  splits[p] = (int)lo;
}

__global__ void __launch_bounds__(MT)
merge_kernel(const u64* a, const u64* b, const int* splits, u64* out,
             long long S) {
  __shared__ u64 buf[PADDED];
  const long long k0 = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, S - k0);
  const long long a0 = splits[blockIdx.x];
  const int acnt = splits[blockIdx.x + 1] - (int)a0;
  const long long b0 = k0 - a0;
  const int bcnt = n - acnt;
  for (int w = threadIdx.x; w < acnt; w += MT) buf[pad(w)] = a[a0 + w];
  for (int w = threadIdx.x; w < bcnt; w += MT) buf[pad(acnt + w)] = b[b0 + w];
  __syncthreads();

  // This thread's diagonal d inside the tile: x a-words and d - x b-words
  // precede its first output word.
  const int d = min((int)threadIdx.x * IPT, n);
  int lo = max(d - bcnt, 0), hi = min(d, acnt);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    const int bi = d - mid;
    const u64 bv = bi < bcnt ? buf[pad(acnt + bi)] : ONES;
    if (buf[pad(mid - 1)] <= bv) lo = mid; else hi = mid - 1;
  }
  int x = lo, y = d - lo;
  u64 v[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const bool a_ok = x < acnt, b_ok = y < bcnt;
    const u64 av = a_ok ? buf[pad(x)] : ONES;
    const u64 bv = b_ok ? buf[pad(acnt + y)] : ONES;
    const bool take_a = a_ok && (!b_ok || av <= bv);
    v[j] = take_a ? av : bv;
    x += take_a ? 1 : 0;
    y += take_a ? 0 : 1;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int w = (int)threadIdx.x * IPT + j;
    if (w < n) buf[pad(w)] = v[j];
  }
  __syncthreads();
  for (int w = threadIdx.x; w < n; w += MT) out[k0 + w] = buf[pad(w)];
}

}  // namespace

// Length of the int32 scratch (the tile splits) for S merged words.
extern "C" long long dj_merge_sorted_u64_scratch_ints(long long S) {
  return (S + TILE - 1) / TILE + 1;
}

// a: R words, b: L words, both ascending unsigned; out: R + L words;
// splits: dj_merge_sorted_u64_scratch_ints(R + L) int32 of scratch.
// R + L must be below 2^31. Returns the CUDA error of the launches, 0
// when both were accepted.
extern "C" int dj_merge_sorted_u64(const u64* a, const u64* b, int* splits,
                                   u64* out, long long R, long long L,
                                   void* stream) {
  const long long S = R + L;
  if (S <= 0) return 0;
  const long long P = (S + TILE - 1) / TILE;
  cudaStream_t st = (cudaStream_t)stream;
  merge_splits_kernel<<<(unsigned)((P + 1 + 255) / 256), 256, 0, st>>>(
      a, b, R, L, P, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<(unsigned)P, MT, 0, st>>>(a, b, splits, out, S);
  return (int)cudaGetLastError();
}
