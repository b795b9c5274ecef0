// The join's "vfull" expansion: every output column of a vcarry join,
// resolved in one pass with no output-sized gather left outside.
//
// Replaces the TPU kernel dj_tpu/ops/pallas_expand.py::expand_vfull
// (_expand_vfull_jit, _make_vfull_kernel). For a sorted int32 csum of
// length S >= 1 and each slot j < n_out, with
// src = min(#{i : csum[i] <= j}, S - 1) and
// rpos = clamp(run_start[src] + j - (csum[src] - cnt[src]), 0, S - 1)
// (int32 wrap before the clamp):
//   lout_k[j] = slot_k[src]     the left payloads (query rows)
//   key_j[j]  = key[rpos]       the key, read at the matched ref
//   rout_k[j] = slot_k[rpos]    the right payloads (ref rows)
// for each u64 payload slot k < n_slots; exact on every slot j < total,
// unspecified past it. The TPU kernel carries every u64 as two int32
// planes (Mosaic has no 64-bit types); this one reads and writes words.
//
// Bound on this card: bytes. csum, cnt and run_start (12 B) and the key
// (8 B) are read per merged position, with 8 B per payload slot; the key
// (8 B) and each payload twice (16 B) are written per output slot. With
// one payload at S = n_out = 200M that is 28 B + 24 B, 10.4 GB, about
// 3.10 ms at the memory rate of an H100 SXM; the search and loads are far
// below the card's operation rate.
//
// Design: the TPU kernel resolves the right side with a second delta-dot
// walk over a margin of positions kept resident below each window, and
// falls back to XLA gathers when the longest run reaches past the margin
// (max_run). A Hopper thread reads global memory at any position, so
// there is no margin and no max_run: each block finds its window of
// merged positions with two searches, stages it in shared memory when it
// fits and searches global memory when it does not (expand_window.cuh);
// each thread reads the left payloads at its rank, computes rpos, and
// reads the key and right payloads there, however far below its query
// the ref lies. The slot count is a template parameter.

#include "expand_window.cuh"

namespace {

using namespace dj_window;

template <int N>
__global__ void expand_vfull_kernel(const int* csum, const int* cnt,
                                    const int* run_start, Slots slots,
                                    const long long* key, SlotOuts louts,
                                    long long* key_j, SlotOuts routs,
                                    long long S, long long n_out) {
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
    long long rp =
        (long long)(int)((unsigned)run_start[src] + (unsigned)j - csum_ex);
    rp = rp < 0 ? 0 : (rp > S - 1 ? S - 1 : rp);
#pragma unroll
    for (int k = 0; k < N; ++k) louts.p[k][j] = slots.p[k][src];
    key_j[j] = key[rp];
#pragma unroll
    for (int k = 0; k < N; ++k) routs.p[k][j] = slots.p[k][rp];
  }
}

template <int N>
void launch(const int* csum, const int* cnt, const int* run_start,
            const Slots& slots, const long long* key, const SlotOuts& louts,
            long long* key_j, const SlotOuts& routs, long long S,
            long long n_out, cudaStream_t stream) {
  expand_vfull_kernel<N><<<blocks_for(n_out), ET, 0, stream>>>(
      csum, cnt, run_start, slots, key, louts, key_j, routs, S, n_out);
}

}  // namespace

// csum, cnt, run_start: S int32 each (S >= 1); slots: host array of
// n_slots (0..3) device pointers to S u64 words each; key: S u64 words;
// louts, routs: host arrays of n_slots device pointers to n_out u64 words
// each; key_j: n_out u64 words. Returns the CUDA error of the launch, 0
// when accepted (-1 for a bad n_slots).
extern "C" int dj_expand_vfull(const int* csum, const int* cnt,
                               const int* run_start,
                               const long long* const* slots, int n_slots,
                               const long long* key, long long* const* louts,
                               long long* key_j, long long* const* routs,
                               long long S, long long n_out, void* stream) {
  if (n_slots < 0 || n_slots > MAX_SLOTS) return -1;
  if (n_out <= 0) return 0;
  const Slots s = slots_from(slots, n_slots);
  const SlotOuts lo = outs_from(louts, n_slots);
  const SlotOuts ro = outs_from(routs, n_slots);
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_slots) {
    case 0: launch<0>(csum, cnt, run_start, s, key, lo, key_j, ro, S, n_out, st); break;
    case 1: launch<1>(csum, cnt, run_start, s, key, lo, key_j, ro, S, n_out, st); break;
    case 2: launch<2>(csum, cnt, run_start, s, key, lo, key_j, ro, S, n_out, st); break;
    default: launch<3>(csum, cnt, run_start, s, key, lo, key_j, ro, S, n_out, st); break;
  }
  return (int)cudaGetLastError();
}
