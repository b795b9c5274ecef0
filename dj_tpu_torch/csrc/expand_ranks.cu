// Rank expansion: which row makes output slot j, for the probe tier and
// the ranks mode.
//
// Replaces the TPU kernel dj_tpu/ops/pallas_expand.py::expand_ranks
// (_expand_ranks_jit -> _run_pallas in ranks mode, _make_ranks_kernel).
// For a sorted non-negative int32 csum of length S and each slot
// j < n_out:
//   out[j] = #{i : csum[i] <= j}
// exact on every slot and every input. The TPU version falls back to an
// XLA histogram under lax.cond when a window overflows its VMEM span;
// this kernel needs no fallback: no CTA ever holds more than NV entries.
//
// Bound on this card: bytes. csum is read (4 B per row) and the int32
// output written (4 B per slot); the work per slot is one comparison,
// far below the card's operation rate. In the probe tier at 100M probe
// rows and 200M slots that is 1.2 GB, about 0.36 ms at the memory rate
// of an H100 SXM.
//
// Design: a load-balanced merge-path search (Baxter's moderngpu; the
// merge path of Green, McColl and Bader, 2012). The output is a merge of
// two sorted sequences, csum[0, S) and the implicit slot values
// 0 .. n_out - 1, with csum[i] placed before slot j when csum[i] <= j;
// out[j] is the number of csum entries merged before slot j.
//   1. ranks_partition: one thread per diagonal d = p * NV runs one
//      binary search over csum (the slots are implicit) for the split
//      a_p = #rows among the first d merged items. All splits are
//      searched in one wave, so the ~27 dependent loads of a search over
//      100M entries are paid once, not once per wave of blocks.
//   2. ranks_merge: CTA p owns the merged items [d_p, d_p+1): rows
//      [a_p, a_p+1) and slots [b_p, b_p+1), b = d - a, NV items in all
//      whatever the distribution of matches. Slot j counts the rows
//      whose csum is <= j, so each row whose csum c falls in the CTA's
//      slots, the last of the rows sharing c, marks slot c in shared
//      memory with its own count, and a CTA-wide inclusive max-scan from
//      a_p (VT slots a thread in registers, then warp shuffles) gives
//      every slot's rank; the CTA stores its slots coalesced. Each
//      thread issues its VT coalesced row loads before it uses the
//      first, which keeps enough loads in flight to stream csum. A CTA
//      with no rows (past the total, or inside one row's long run of
//      slots) fills its slots with 16-byte stores.
// csum is read once and out written once; no slot is searched for, and
// a row with a million matches spreads over some 300 CTAs.
//
// A csum that wrapped past 2^31 is not sorted; its slots are unspecified
// to the caller, which clamps them. The search runs over a fixed
// interval, so each split is non-decreasing in its diagonal for any
// input: every CTA then holds at most NV rows and NV slots, every slot
// is written, every value written lies in [0, S], and nothing outside
// csum[0, S) and out[0, n_out) is read or written.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads per merge CTA
constexpr int VT = 13;         // rows a thread loads, slots it scans (odd: no bank conflicts)
constexpr int NV = NT * VT;    // merged items per CTA
constexpr int PT = 256;        // threads per partition block

// #rows among the first d merged items: the count of m in [0, S) with
// csum[m] + m <= d - 1, clamped into [max(0, d - n_out), min(d, S)].
__device__ __forceinline__ long long global_split(const int* csum, long long S,
                                                  long long n_out, long long d) {
  long long lo = 0, hi = S;
  while (lo < hi) {
    const long long m = (lo + hi) >> 1;
    if ((long long)csum[m] + m <= d - 1) lo = m + 1; else hi = m;
  }
  return min(max(lo, d - n_out), min(d, S));
}

__global__ void ranks_partition(const int* csum, long long* splits, long long S,
                                long long n_out, long long n_ctas) {
  const long long p = (long long)blockIdx.x * PT + threadIdx.x;
  if (p > n_ctas) return;
  splits[p] = global_split(csum, S, n_out, min(p * NV, S + n_out));
}

__global__ void __launch_bounds__(NT)
ranks_merge(const int* __restrict__ csum, const long long* __restrict__ splits,
            int* __restrict__ out, long long S, long long n_out) {
  __shared__ int rank[NV];
  __shared__ int warp_max[NT / 32];
  const long long d0 = (long long)blockIdx.x * NV;
  const long long d1 = min(d0 + NV, S + n_out);
  const long long a0 = splits[blockIdx.x], a1 = splits[blockIdx.x + 1];
  const long long b0 = d0 - a0, b1 = d1 - a1;
  if (b1 <= b0) return;  // no slots: a row-only CTA
  // Splits never decrease, so na >= 0 and na + nb = d1 - d0 <= NV.
  const int nb = (int)(b1 - b0), na = (int)(a1 - a0);
  if (na == 0) {
    // Every slot ranks a0: scalar stores up to a 16-byte boundary of out
    // (which the allocator aligns), then int4 stores, then the tail.
    int* o = out + b0;
    const int head = min(nb, (int)((4 - (b0 & 3)) & 3));
    const int nvec = (nb - head) >> 2;
    const int4 a4 = make_int4((int)a0, (int)a0, (int)a0, (int)a0);
    if ((int)threadIdx.x < head) o[threadIdx.x] = (int)a0;
    for (int k = threadIdx.x; k < nvec; k += NT) reinterpret_cast<int4*>(o + head)[k] = a4;
    if (head + 4 * nvec + (int)threadIdx.x < nb) o[head + 4 * nvec + threadIdx.x] = (int)a0;
    return;
  }
  // Row a0 + t + i NT for i < VT (na <= NV): every load is issued before
  // the first is used, so each thread keeps VT loads in flight.
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int c[VT];
#pragma unroll
  for (int i = 0; i < VT; ++i) {
    const int k = t + i * NT;
    c[i] = k < na ? csum[a0 + k] : 0;
  }
#pragma unroll
  for (int i = 0; i < VT; ++i) {
    if (t + i * NT < nb) rank[t + i * NT] = 0;
  }
  __syncthreads();
  // Row a0 + k with csum c in [b0, b1), the last of the rows that share
  // c, marks slot c: from there on a0 + k + 1 rows are counted. A row of
  // a sorted csum has c >= b0 (the merge put slot b0 - 1 before it), and
  // the CTA's last row shares c < b1 with no later row (the next CTA's
  // first row has c >= b1). The next row's csum is the next lane's, or
  // for the last lane a load that the cache already holds.
#pragma unroll
  for (int i = 0; i < VT; ++i) {
    const int k = t + i * NT;
    int next = __shfl_down_sync(0xFFFFFFFFu, c[i], 1);
    if (lane == 31 && k + 1 < na) next = csum[a0 + k + 1];
    const long long rel = (long long)c[i] - b0;
    if (k < na && rel >= 0 && rel < nb && (k + 1 == na || next != c[i])) {
      rank[rel] = (int)(a0 + k + 1);
    }
  }
  __syncthreads();
  // Inclusive max-scan of the marks from a0: VT consecutive slots a
  // thread in registers, then the thread maxima across the warp
  // (shuffles) and across the CTA's warps (shared memory).
  int v[VT];
  int run = (int)a0;
#pragma unroll
  for (int k = 0; k < VT; ++k) {
    const int i = t * VT + k;
    if (i < nb) run = max(run, rank[i]);
    v[k] = run;
  }
  int inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xFFFFFFFFu, inc, off);
    if (lane >= off) inc = max(inc, o);
  }
  if (lane == 31) warp_max[warp] = inc;
  int before = __shfl_up_sync(0xFFFFFFFFu, inc, 1);
  if (lane == 0) before = (int)a0;
  __syncthreads();
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
#pragma unroll
  for (int k = 0; k < VT; ++k) {
    const int i = t * VT + k;
    if (i < nb) rank[i] = max(before, v[k]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nb; k += NT) out[b0 + k] = rank[k];
}

}  // namespace

// csum: S int32 (S >= 0), ascending and non-negative; out: n_out int32;
// splits: ceil((S + n_out) / NV) + 1 int64 of scratch (the wrapper's
// RANKS_NV is NV). Two launches on ``stream``. Returns the CUDA error of
// either launch, 0 when both are accepted.
extern "C" int dj_expand_ranks(const int* csum, int* out, long long* splits,
                               long long S, long long n_out, void* stream) {
  if (n_out <= 0) return 0;
  const long long n_ctas = (S + n_out + NV - 1) / NV;
  const cudaStream_t st = (cudaStream_t)stream;
  ranks_partition<<<(unsigned)((n_ctas + PT) / PT), PT, 0, st>>>(csum, splits, S, n_out,
                                                                 n_ctas);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ranks_merge<<<(unsigned)n_ctas, NT, 0, st>>>(csum, splits, out, S, n_out);
  return (int)cudaGetLastError();
}
