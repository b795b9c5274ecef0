// Duplicate expansion of the join: which merged position makes output j.
//
// Replaces the TPU kernel dj_tpu/ops/pallas_expand.py::expand_values
// (_make_vexpand_kernel). For each output slot j < n_out:
//   src  = min(#{i : csum[i] <= j}, S - 1)
//   stag_j[j] = stag[src]
//   rpos[j]   = run_start[src] + j - (csum[src] - cnt[src])   (int32 wrap)
// exact on every slot j < total; slots past total get the same formula
// and are unspecified to the caller.
//
// Bound on this card: bytes. csum, cnt, stag and run_start are read
// (16 B per merged position) and two int32 outputs are written (8 B per
// slot); the work per slot is one short binary search, far below the
// card's operation rate. At S = n_out = 200M that is about 4.8 GB, or
// about 1.4 ms at the memory rate of an H100 SXM.
//
// Design: the TPU kernel computes the gather as an MXU product of a
// comparison mask with value deltas, because a TPU core cannot gather
// from its vector memory. Hopper gathers natively, so none of that is
// kept. Each block owns ETILE consecutive output slots. Two binary
// searches of csum in global memory give the block's window of merged
// positions [lo, hi) (a merge-path split: every src of the block lies in
// [lo, hi]). A window of at most WIN entries is staged in shared memory
// and each thread finds its src by a binary search there; a larger window
// (a key shared by many rows on both sides) is searched in global memory
// over the same range, so the kernel is exact for every window size.
// Consecutive slots have non-decreasing src, so the gathers of stag,
// run_start and cnt at src read neighbouring addresses.

#include <cuda_runtime.h>

namespace {

constexpr int ET = 256;            // threads per block
constexpr int EJ = 4;              // output slots per thread
constexpr int ETILE = ET * EJ;     // output slots per block
constexpr int WIN = 8192;          // csum entries staged in shared memory

// First index in [lo, hi) whose value exceeds v (hi if none).
__device__ __forceinline__ long long upper_bound(const int* a, long long lo,
                                                 long long hi, long long v) {
  while (lo < hi) {
    const long long m = (lo + hi) >> 1;
    if ((long long)a[m] <= v) lo = m + 1; else hi = m;
  }
  return lo;
}

__global__ void expand_values_kernel(const int* csum, const int* cnt,
                                     const int* stag, const int* run_start,
                                     int* stag_j, int* rpos, long long S,
                                     long long n_out) {
  __shared__ int win[WIN];
  __shared__ long long bounds[2];
  const long long j0 = (long long)blockIdx.x * ETILE;
  const long long j_last = min(j0 + ETILE, n_out) - 1;
  if (threadIdx.x == 0) bounds[0] = upper_bound(csum, 0, S, j0);
  if (threadIdx.x == 32) bounds[1] = upper_bound(csum, 0, S, j_last);
  __syncthreads();
  const long long lo = bounds[0];
  // A csum that wrapped past 2^31 is not sorted; the window then only
  // has to stay a valid range (those slots are unspecified).
  const long long width = max(bounds[1] - lo, 0LL);
  const bool staged = width <= WIN;
  if (staged) {
    for (long long k = threadIdx.x; k < width; k += ET) win[k] = csum[lo + k];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < EJ; ++e) {
    const long long j = j0 + (long long)e * ET + threadIdx.x;
    if (j >= n_out) break;
    long long a;
    if (staged) {
      a = upper_bound(win, 0, width, j);
    } else {
      a = upper_bound(csum + lo, 0, width, j);
    }
    long long src = lo + a;
    if (src > S - 1) src = S - 1;
    const unsigned csum_ex = (unsigned)csum[src] - (unsigned)cnt[src];
    stag_j[j] = stag[src];
    rpos[j] = (int)((unsigned)run_start[src] + (unsigned)j - csum_ex);
  }
}

}  // namespace

// csum, cnt, stag, run_start: S int32 each (S >= 1); stag_j, rpos: n_out
// int32 each. Returns the CUDA error of the launch, 0 when accepted.
extern "C" int dj_expand_values(const int* csum, const int* cnt, const int* stag,
                                const int* run_start, int* stag_j, int* rpos,
                                long long S, long long n_out, void* stream) {
  if (n_out <= 0) return 0;
  const long long nblocks = (n_out + ETILE - 1) / ETILE;
  expand_values_kernel<<<(unsigned)nblocks, ET, 0, (cudaStream_t)stream>>>(
      csum, cnt, stag, run_start, stag_j, rpos, S, n_out);
  return (int)cudaGetLastError();
}
