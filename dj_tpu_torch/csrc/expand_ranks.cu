// Rank expansion: which row makes output slot j, for the probe tier.
//
// Replaces the TPU kernel dj_tpu/ops/pallas_expand.py::expand_ranks
// (_expand_ranks_jit -> _run_pallas in ranks mode, _make_ranks_kernel).
// For a sorted non-negative int32 csum of length S and each slot
// j < n_out:
//   out[j] = #{i : csum[i] <= j}
// exact on every slot and every input. The TPU version falls back to an
// XLA histogram under lax.cond when a window overflows its VMEM span;
// this kernel has no fallback: it searches global memory instead.
//
// Bound on this card: bytes. csum is read (4 B per row) and the int32
// output written (4 B per slot); the work per slot is one short binary
// search, far below the card's operation rate. In the probe tier at
// 100M probe rows and 200M slots that is 1.2 GB, about 0.36 ms at the
// memory rate of an H100 SXM.
//
// Design: the windowing of csrc/expand_values.cu, whose src output this
// is, as csrc/expand_window.cuh shares it. Each block owns ETILE consecutive output slots. Two binary searches
// of csum in global memory give the block's window of rows [lo, hi)
// (every slot's answer lies in [lo, hi]); a slot at or past the total
// (csum's last, largest value) ranks S without a search, so the blocks
// past the total, most of them when out_cap is well above the total, do
// not pay two full-depth searches each. A window of at most WIN
// entries is staged in shared memory and each thread searches there; a
// wider window (sparse matches: many rows per slot) is searched in
// global memory over the same range. Each slot is found by its own
// thread, so a row with a million matches (a million slots of the same
// answer) spreads over a thousand blocks instead of serialising one
// thread.

#include "expand_window.cuh"

namespace {

using namespace dj_window;

__global__ void expand_ranks_kernel(const int* csum, int* out, long long S,
                                    long long n_out) {
  __shared__ int win[WIN];
  __shared__ long long bounds[2];
  // A csum that is not sorted (wrapped past 2^31) only has to give a
  // valid range: the caller's overflow flag condemns those slots.
  const Window w = stage(csum, S, n_out, win, bounds);
  const long long j0 = (long long)blockIdx.x * ETILE;
#pragma unroll
  for (int e = 0; e < EJ; ++e) {
    const long long j = j0 + (long long)e * ET + threadIdx.x;
    if (j >= n_out) break;
    out[j] = (int)rank(w, csum, win, j);
  }
}

}  // namespace

// csum: S int32 (S >= 0), ascending and non-negative; out: n_out int32.
// Returns the CUDA error of the launch, 0 when accepted.
extern "C" int dj_expand_ranks(const int* csum, int* out, long long S,
                               long long n_out, void* stream) {
  if (n_out <= 0) return 0;
  expand_ranks_kernel<<<blocks_for(n_out), ET, 0, (cudaStream_t)stream>>>(
      csum, out, S, n_out);
  return (int)cudaGetLastError();
}
