// Ranks plus the metadata gather of the join's "fused" expansion mode.
//
// Replaces the TPU kernel dj_tpu/ops/pallas_expand.py::expand_gather
// (_expand_gather_jit -> _run_pallas in mode "meta", _make_kernel). For
// a sorted int32 csum of length S >= 1 and each slot j < n_out:
//   src[j]      = #{i : csum[i] <= j}
//   stag_j[j]   = stag[min(src, S - 1)]
//   rstart_j[j] = run_start[min(src, S - 1)]
// exact on every slot j < total; slots past the total are unspecified to
// the caller. On a TPU this kernel runs only in interpret mode: its
// in-kernel gathers have no TPU instruction.
//
// Bound on this card: bytes. csum, stag and run_start are read (12 B per
// merged position) and three int32 outputs are written (12 B per slot);
// the work per slot is one short binary search and two loads, far below
// the card's operation rate. At S = n_out = 200M that is 4.8 GB, about
// 1.43 ms at the memory rate of an H100 SXM.
//
// Design: the TPU kernel streams csum windows into VMEM and counts each
// slot's rank by vector compares. Here each block finds its window of
// merged positions with two searches, stages it in shared memory when it
// fits and searches global memory when it does not (expand_window.cuh),
// so it is exact with no fallback; then each thread gathers stag and
// run_start at its own rank. Consecutive slots have non-decreasing ranks,
// so the gathers read neighbouring addresses.

#include "expand_window.cuh"

namespace {

using namespace dj_window;

__global__ void expand_gather_kernel(const int* csum, const int* stag,
                                     const int* run_start, int* src_out,
                                     int* stag_j, int* rstart_j, long long S,
                                     long long n_out) {
  __shared__ int win[WIN];
  __shared__ long long bounds[2];
  const Window w = stage(csum, S, n_out, win, bounds);
  const long long j0 = (long long)blockIdx.x * ETILE;
#pragma unroll
  for (int e = 0; e < EJ; ++e) {
    const long long j = j0 + (long long)e * ET + threadIdx.x;
    if (j >= n_out) break;
    const long long src = rank(w, csum, win, j);
    const long long s = src < S ? src : S - 1;
    src_out[j] = (int)src;
    stag_j[j] = stag[s];
    rstart_j[j] = run_start[s];
  }
}

}  // namespace

// csum, stag, run_start: S int32 each (S >= 1); src, stag_j, rstart_j:
// n_out int32 each. Returns the CUDA error of the launch, 0 when accepted.
extern "C" int dj_expand_gather(const int* csum, const int* stag,
                                const int* run_start, int* src, int* stag_j,
                                int* rstart_j, long long S, long long n_out,
                                void* stream) {
  if (n_out <= 0) return 0;
  expand_gather_kernel<<<blocks_for(n_out), ET, 0, (cudaStream_t)stream>>>(
      csum, stag, run_start, src, stag_j, rstart_j, S, n_out);
  return (int)cudaGetLastError();
}
