// The whole expansion of the join's "join" mode: both row tags per slot.
//
// Replaces the TPU kernel dj_tpu/ops/pallas_expand.py::expand_join
// (_expand_join_jit -> _run_pallas in mode "join", _make_kernel). For a
// sorted int32 csum of length S >= 1 and each slot j < n_out, with
// src = min(#{i : csum[i] <= j}, S - 1):
//   t       = j - (src > 0 ? csum[src - 1] : 0)              (int32 wrap)
//   stag_j  = stag[src]
//   rtag    = stag[clamp(run_start[src] + t, 0, S - 1)]      (int32 wrap)
// exact on every slot j < total; slots past the total are unspecified to
// the caller. On a TPU this kernel runs only in interpret mode: its
// in-kernel gathers have no TPU instruction.
//
// Bound on this card: bytes. csum, stag and run_start are read (12 B per
// merged position) and two int32 outputs are written (8 B per slot); the
// work per slot is one short binary search and four loads, far below the
// card's operation rate. At S = n_out = 200M that is 4.0 GB, about
// 1.19 ms at the memory rate of an H100 SXM.
//
// Design: the TPU kernel keeps a margin of positions below each window
// resident in VMEM, so that a matched ref (which sits below its query)
// can be read there, and falls back to XLA when the longest run reaches
// past the margin (max_run). A Hopper thread reads global memory at any
// position, so there is no margin and no max_run: each block finds its
// window of merged positions with two searches, stages it in shared
// memory when it fits and searches global memory when it does not
// (expand_window.cuh); each thread then reads the meta words at its rank
// and the matched ref's tag wherever it lies, so a key with a million
// refs stays exact.

#include "expand_window.cuh"

namespace {

using namespace dj_window;

__global__ void expand_join_kernel(const int* csum, const int* stag,
                                   const int* run_start, int* stag_j,
                                   int* rtag, long long S, long long n_out) {
  __shared__ int win[WIN];
  __shared__ long long bounds[2];
  const Window w = stage(csum, S, n_out, win, bounds);
  const long long j0 = (long long)blockIdx.x * ETILE;
#pragma unroll
  for (int e = 0; e < EJ; ++e) {
    const long long j = j0 + (long long)e * ET + threadIdx.x;
    if (j >= n_out) break;
    long long src = rank(w, csum, win, j);
    if (src > S - 1) src = S - 1;
    const unsigned csum_ex = src > 0 ? (unsigned)csum[src - 1] : 0u;
    const unsigned t = (unsigned)j - csum_ex;
    long long rp = (long long)(int)((unsigned)run_start[src] + t);
    rp = rp < 0 ? 0 : (rp > S - 1 ? S - 1 : rp);
    stag_j[j] = stag[src];
    rtag[j] = stag[rp];
  }
}

}  // namespace

// csum, stag, run_start: S int32 each (S >= 1); stag_j, rtag: n_out int32
// each. Returns the CUDA error of the launch, 0 when accepted.
extern "C" int dj_expand_join(const int* csum, const int* stag,
                              const int* run_start, int* stag_j, int* rtag,
                              long long S, long long n_out, void* stream) {
  if (n_out <= 0) return 0;
  expand_join_kernel<<<blocks_for(n_out), ET, 0, (cudaStream_t)stream>>>(
      csum, stag, run_start, stag_j, rtag, S, n_out);
  return (int)cudaGetLastError();
}
