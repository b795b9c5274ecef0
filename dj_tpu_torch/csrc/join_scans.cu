// Match-range scans of the join over the sorted packed words.
//
// Replaces the TPU kernel dj_tpu/ops/pallas_scan.py::join_scans
// (_make_scan_kernel). From the ascending packed u64 words
// ((key - min) << tag_bits | tag, padding all-ones) it writes four int32
// arrays: stag (decoded merged tag), run_start (start of the position's
// key run), cnt (refs in the run, for a valid left row) and csum (the
// inclusive int32 cumsum of cnt, wrapping past 2^31 as the JAX kernel
// does; the exact int64 total is cnt's sum, taken by the caller).
//
// Bound on this card: bytes. It must read 8 B and write 16 B per
// position and does a few integer operations on each, far below the
// card's operation rate, so the least time is 24 B x S over the memory
// rate (about 1.4 ms at S = 200M on an H100 SXM).
//
// Design: the TPU kernel carries its prefix state (query count, run
// carries, csum) in SMEM across a grid that runs in order. Hopper blocks
// run in no order, so the carry becomes a reduce-then-scan:
//   1. scan_reduce: each block of TILE positions writes its query count,
//      the position of its last run boundary, and the queries before
//      that boundary within the block;
//   2. scan_blocks_runs: one block scans those aggregates into each
//      block's carried query count and carried (run_start, run_lo);
//   3. scan_cnt: each block rewrites its positions with the carries and
//      writes stag, run_start and cnt, and its cnt sum;
//   4. scan_blocks_sum: one block scans the cnt sums;
//   5. scan_csum: each block writes csum from cnt and its carry.
// run_start and run_lo are max-scans (both grow along the positions)
// and the counts are sum-scans, so each block-level carry is one
// associative scan. The boundary test at a thread's first position reads
// the previous word from global memory. The passes read the words twice
// and cnt once more: about 32 B per position instead of the bound's 24.
// Each thread owns ITEMS consecutive positions, loaded and stored as
// 16-byte vectors.

#include <climits>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr int SCAN_THREADS = 1024;
constexpr int NEG = INT_MIN;

struct Add {
  __device__ int operator()(int a, int b) const {
    return (int)((unsigned)a + (unsigned)b);  // int32 wraparound
  }
};
struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

template <class Op>
__device__ __forceinline__ int warp_inclusive(int v, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = op(y, v);
  }
  return v;
}

// Exclusive scan of one value per thread across the block; ``total``
// receives the block aggregate. ``buf`` holds >= 32 ints of shared memory.
template <class Op>
__device__ int block_exclusive(int v, Op op, int identity, int* buf, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = warp_inclusive(v, op);
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? buf[lane] : identity;
    w = warp_inclusive(w, op);
    if (lane < nw) buf[lane] = w;
  }
  __syncthreads();
  int before_warp = warp == 0 ? identity : buf[warp - 1];
  total = buf[nw - 1];
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = identity;
  __syncthreads();  // buf may be reused by the next call
  return op(before_warp, excl);
}

struct Geometry {
  long long S;
  int L, R, tag_bits;
};

__device__ __forceinline__ int decode_tag(u64 w, const Geometry& g) {
  const int raw = (int)(w & ((1ull << g.tag_bits) - 1));
  const int S = (int)g.S;
  return raw < g.R ? raw + g.L : (raw < S ? raw - g.R : S);
}

// This thread's ITEMS words (all-ones past S) and the word before them.
__device__ __forceinline__ void load_words(const u64* sp, long long S, long long g0,
                                           u64 (&w)[ITEMS], u64& prev) {
  if (g0 + ITEMS <= S) {
    const ulonglong2* v = reinterpret_cast<const ulonglong2*>(sp + g0);
#pragma unroll
    for (int k = 0; k < ITEMS / 2; ++k) {
      ulonglong2 x = v[k];
      w[2 * k] = x.x;
      w[2 * k + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) w[k] = g0 + k < S ? sp[g0 + k] : ~0ull;
  }
  prev = g0 > 0 && g0 <= S ? sp[g0 - 1] : 0ull;
}

__device__ __forceinline__ void store_ints(int* out, long long S, long long g0,
                                           const int (&v)[ITEMS]) {
  if (g0 + ITEMS <= S) {
    int4* o = reinterpret_cast<int4*>(out + g0);
#pragma unroll
    for (int k = 0; k < ITEMS / 4; ++k)
      o[k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (g0 + k < S) out[g0 + k] = v[k];
  }
}

// Per position: decoded tag, whether it starts a key run.
__device__ __forceinline__ void decode_items(const u64* sp, const Geometry& geo,
                                             long long g0, int (&stag)[ITEMS],
                                             bool (&bnd)[ITEMS]) {
  u64 w[ITEMS], prev;
  load_words(sp, geo.S, g0, w, prev);
  const int tb = geo.tag_bits;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long g = g0 + k;
    const u64 before = k == 0 ? prev : w[k - 1];
    stag[k] = decode_tag(w[k], geo);
    bnd[k] = g < geo.S && (g == 0 || (w[k] >> tb) != (before >> tb));
  }
}

__global__ void scan_reduce(const u64* sp, Geometry geo, int* blk_q,
                            int* blk_lastb, int* blk_qb) {
  __shared__ int buf[32];
  const long long g0 = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  int stag[ITEMS];
  bool bnd[ITEMS];
  decode_items(sp, geo, g0, stag, bnd);
  int nq = 0, lastb = -1, qb = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (bnd[k]) {
      lastb = (int)(g0 + k);
      qb = nq;
    }
    nq += (g0 + k < geo.S && stag[k] < geo.L) ? 1 : 0;
  }
  int q_total, b_total;
  const int q_before = block_exclusive(nq, Add(), 0, buf, q_total);
  block_exclusive(lastb, Max(), -1, buf, b_total);
  if (threadIdx.x == 0) {
    blk_q[blockIdx.x] = q_total;
    blk_lastb[blockIdx.x] = b_total;
  }
  if (lastb >= 0 && lastb == b_total) blk_qb[blockIdx.x] = q_before + qb;
}

// One block: carried query count and carried (run_start, run_lo) of every
// tile. run_lo at a boundary b is ref_before(b) = b - q_before(b).
__global__ void scan_blocks_runs(int nb, const int* blk_q, const int* blk_lastb,
                                 const int* blk_qb, int* q_in, int* rs_in,
                                 int* rl_in) {
  __shared__ int buf[32];
  const int per = (nb + SCAN_THREADS - 1) / SCAN_THREADS;
  const int b0 = threadIdx.x * per;
  const int b1 = min(nb, b0 + per);
  int qsum = 0;
  for (int b = b0; b < b1; ++b) qsum += blk_q[b];
  int total;
  int q = block_exclusive(qsum, Add(), 0, buf, total);
  int rs_max = NEG, rl_max = NEG;
  for (int b = b0; b < b1; ++b) {
    q_in[b] = q;
    if (blk_lastb[b] >= 0) {
      rs_max = blk_lastb[b];
      rl_max = blk_lastb[b] - (q + blk_qb[b]);
    }
    q += blk_q[b];
  }
  int rs = block_exclusive(rs_max, Max(), NEG, buf, total);
  int rl = block_exclusive(rl_max, Max(), NEG, buf, total);
  for (int b = b0; b < b1; ++b) {
    rs_in[b] = rs;
    rl_in[b] = rl;
    if (blk_lastb[b] >= 0) {
      rs = blk_lastb[b];
      rl = blk_lastb[b] - (q_in[b] + blk_qb[b]);
    }
  }
}

__global__ void scan_cnt(const u64* sp, Geometry geo, const int* counts,
                         const int* q_in, const int* rs_in, const int* rl_in,
                         int* stag_out, int* rstart_out, int* cnt_out,
                         int* blk_c) {
  __shared__ int buf[32];
  const long long g0 = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  const int l_count = counts[0], r_count = counts[1];
  int stag[ITEMS];
  bool bnd[ITEMS];
  decode_items(sp, geo, g0, stag, bnd);
  int nq = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) nq += stag[k] < geo.L ? 1 : 0;
  int total;
  int q = q_in[blockIdx.x] + block_exclusive(nq, Add(), 0, buf, total);
  // Per position: ref_before and the run values a boundary there sets.
  int ref_before[ITEMS];
  int rs_local = NEG, rl_local = NEG;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    ref_before[k] = (int)(g0 + k) - q;
    q += stag[k] < geo.L ? 1 : 0;
    if (bnd[k]) {
      rs_local = (int)(g0 + k);
      rl_local = ref_before[k];
    }
  }
  int rs = max(rs_in[blockIdx.x], block_exclusive(rs_local, Max(), NEG, buf, total));
  int rl = max(rl_in[blockIdx.x], block_exclusive(rl_local, Max(), NEG, buf, total));
  int run_start[ITEMS], cnt[ITEMS];
  int csum_local = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (bnd[k]) {
      rs = (int)(g0 + k);
      rl = ref_before[k];
    }
    run_start[k] = rs;
    const int hi = min(ref_before[k], r_count);
    cnt[k] = stag[k] < l_count ? max(hi - rl, 0) : 0;
    if (g0 + k < geo.S) csum_local = Add()(csum_local, cnt[k]);
  }
  store_ints(stag_out, geo.S, g0, stag);
  store_ints(rstart_out, geo.S, g0, run_start);
  store_ints(cnt_out, geo.S, g0, cnt);
  block_exclusive(csum_local, Add(), 0, buf, total);
  if (threadIdx.x == 0) blk_c[blockIdx.x] = total;
}

__global__ void scan_blocks_sum(int nb, const int* blk_c, int* c_in) {
  __shared__ int buf[32];
  const int per = (nb + SCAN_THREADS - 1) / SCAN_THREADS;
  const int b0 = threadIdx.x * per;
  const int b1 = min(nb, b0 + per);
  int s = 0;
  for (int b = b0; b < b1; ++b) s = Add()(s, blk_c[b]);
  int total;
  int c = block_exclusive(s, Add(), 0, buf, total);
  for (int b = b0; b < b1; ++b) {
    c_in[b] = c;
    c = Add()(c, blk_c[b]);
  }
}

__global__ void scan_csum(long long S, const int* cnt, const int* c_in, int* csum) {
  __shared__ int buf[32];
  const long long g0 = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  int v[ITEMS];
  if (g0 + ITEMS <= S) {
    const int4* p = reinterpret_cast<const int4*>(cnt + g0);
#pragma unroll
    for (int k = 0; k < ITEMS / 4; ++k) {
      int4 x = p[k];
      v[4 * k] = x.x;
      v[4 * k + 1] = x.y;
      v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) v[k] = g0 + k < S ? cnt[g0 + k] : 0;
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) s = Add()(s, v[k]);
  int total;
  int c = Add()(c_in[blockIdx.x], block_exclusive(s, Add(), 0, buf, total));
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    c = Add()(c, v[k]);
    v[k] = c;
  }
  store_ints(csum, S, g0, v);
}

int num_tiles(long long S) { return (int)((S + TILE - 1) / TILE); }

}  // namespace

extern "C" long long dj_join_scans_scratch_ints(long long S) {
  return 8LL * num_tiles(S);
}

// sp: S words; counts: device int32 [l_count, r_count]; outputs: S int32
// each; scratch: dj_join_scans_scratch_ints(S) int32. Returns the first
// CUDA error of the launches, 0 when all were accepted.
extern "C" int dj_join_scans(const u64* sp, const int* counts, int* stag,
                             int* run_start, int* cnt, int* csum, int* scratch,
                             long long S, int L, int R, int tag_bits, void* stream) {
  if (S <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = num_tiles(S);
  int* blk_q = scratch;
  int* blk_lastb = scratch + nb;
  int* blk_qb = scratch + 2 * nb;
  int* q_in = scratch + 3 * nb;
  int* rs_in = scratch + 4 * nb;
  int* rl_in = scratch + 5 * nb;
  int* blk_c = scratch + 6 * nb;
  int* c_in = scratch + 7 * nb;
  Geometry geo{S, L, R, tag_bits};
  cudaError_t e;
  scan_reduce<<<nb, THREADS, 0, st>>>(sp, geo, blk_q, blk_lastb, blk_qb);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_blocks_runs<<<1, SCAN_THREADS, 0, st>>>(nb, blk_q, blk_lastb, blk_qb, q_in,
                                               rs_in, rl_in);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_cnt<<<nb, THREADS, 0, st>>>(sp, geo, counts, q_in, rs_in, rl_in, stag,
                                   run_start, cnt, blk_c);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_blocks_sum<<<1, SCAN_THREADS, 0, st>>>(nb, blk_c, c_in);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_csum<<<nb, THREADS, 0, st>>>(S, cnt, c_in, csum);
  return (int)cudaGetLastError();
}
