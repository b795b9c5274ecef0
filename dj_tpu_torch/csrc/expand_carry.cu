// The join's "vcarry" expansion: the matched ref's position and the left
// payloads that rode the sort, per output slot.
//
// Replaces the TPU kernel dj_tpu/ops/pallas_expand.py::expand_carry
// (_expand_carry_jit -> _run_vexpand, _make_vexpand_kernel). For a sorted
// int32 csum of length S >= 1 and each slot j < n_out, with
// src = min(#{i : csum[i] <= j}, S - 1):
//   rpos[j]    = run_start[src] + j - (csum[src] - cnt[src])   (int32 wrap)
//   out_k[j]   = slot_k[src]        for each u64 payload slot k < n_slots
// exact on every slot j < total; slots past the total are unspecified to
// the caller. The TPU kernel carries each u64 slot as two int32 planes
// (Mosaic has no 64-bit types); this one reads and writes the u64 words.
//
// Bound on this card: bytes. csum, cnt and run_start are read (12 B per
// merged position) with 8 B per payload slot, and rpos (4 B) and the
// payloads (8 B each) are written per output slot. With one payload at
// S = n_out = 200M that is 20 B + 12 B, 6.4 GB, about 1.91 ms at the
// memory rate of an H100 SXM; the search and loads are far below the
// card's operation rate.
//
// Design: the TPU kernel expands the payloads at src as an exact MXU
// product of a comparison mask with value deltas, because a TPU core
// cannot gather from its vector memory. Hopper gathers natively, so none
// of that is kept: each block finds its window of merged positions with
// two searches, stages it in shared memory when it fits and searches
// global memory when it does not (expand_window.cuh), and each thread
// reads the run metadata and the payload words at its own rank. The slot
// count is a template parameter, so the payload loop unrolls.

#include "expand_window.cuh"

namespace {

using namespace dj_window;

template <int N>
__global__ void expand_carry_kernel(const int* csum, const int* cnt,
                                    const int* run_start, Slots slots,
                                    int* rpos, SlotOuts outs, long long S,
                                    long long n_out) {
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
    const unsigned csum_ex = (unsigned)csum[src] - (unsigned)cnt[src];
    rpos[j] = (int)((unsigned)run_start[src] + (unsigned)j - csum_ex);
#pragma unroll
    for (int k = 0; k < N; ++k) outs.p[k][j] = slots.p[k][src];
  }
}

template <int N>
void launch(const int* csum, const int* cnt, const int* run_start,
            const Slots& slots, int* rpos, const SlotOuts& outs, long long S,
            long long n_out, cudaStream_t stream) {
  expand_carry_kernel<N><<<blocks_for(n_out), ET, 0, stream>>>(
      csum, cnt, run_start, slots, rpos, outs, S, n_out);
}

}  // namespace

// csum, cnt, run_start: S int32 each (S >= 1); slots: host array of
// n_slots (0..3) device pointers to S u64 words each; rpos: n_out int32;
// outs: host array of n_slots device pointers to n_out u64 words each.
// Returns the CUDA error of the launch, 0 when accepted (-1 for a bad
// n_slots).
extern "C" int dj_expand_carry(const int* csum, const int* cnt,
                               const int* run_start,
                               const long long* const* slots, int n_slots,
                               int* rpos, long long* const* outs, long long S,
                               long long n_out, void* stream) {
  if (n_slots < 0 || n_slots > MAX_SLOTS) return -1;
  if (n_out <= 0) return 0;
  const Slots s = slots_from(slots, n_slots);
  const SlotOuts o = outs_from(outs, n_slots);
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_slots) {
    case 0: launch<0>(csum, cnt, run_start, s, rpos, o, S, n_out, st); break;
    case 1: launch<1>(csum, cnt, run_start, s, rpos, o, S, n_out, st); break;
    case 2: launch<2>(csum, cnt, run_start, s, rpos, o, S, n_out, st); break;
    default: launch<3>(csum, cnt, run_start, s, rpos, o, S, n_out, st); break;
  }
  return (int)cudaGetLastError();
}
