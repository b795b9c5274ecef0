// The merge-path window shared by the expansion kernels expand_values,
// expand_ranks, expand_gather, expand_join, expand_carry and
// expand_vfull (each in its own .cu file).
//
// Each block owns ETILE consecutive output slots [j0, j_last]. Two binary
// searches of csum in global memory give the block's window of merged
// positions [lo, lo + width): every slot's rank #{i : csum[i] <= j} lies
// in [lo, lo + width]. A slot at or past csum's last value (the total)
// ranks S without a search, so the blocks past the total do not pay two
// full-depth searches each. A window of at most WIN entries is staged in
// shared memory and each thread searches there; a wider window (sparse
// matches, or a key with many refs) is searched in global memory over the
// same range, so the rank is exact for every window size. Each slot is
// found by its own thread. A csum that wrapped past 2^31 is not sorted;
// the window then only has to stay a valid range (those slots are
// unspecified to the caller).

#pragma once

#include <cuda_runtime.h>

namespace dj_window {

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

// #{i < S : csum[i] <= v}; a v at or past csum's last value is S.
__device__ __forceinline__ long long rank_of(const int* csum, long long S,
                                             long long v) {
  if (S == 0 || (long long)csum[S - 1] <= v) return S;
  return upper_bound(csum, 0, S - 1, v);
}

struct Window {
  long long lo;
  long long width;
  bool staged;
};

// The window of this block's slots, staged into ``win`` when it fits.
// Every thread of the block calls it (it synchronises the block).
__device__ __forceinline__ Window stage(const int* csum, long long S,
                                        long long n_out, int* win,
                                        long long* bounds) {
  const long long j0 = (long long)blockIdx.x * ETILE;
  const long long j_last = min(j0 + ETILE, n_out) - 1;
  if (threadIdx.x == 0) bounds[0] = rank_of(csum, S, j0);
  if (threadIdx.x == 32) bounds[1] = rank_of(csum, S, j_last);
  __syncthreads();
  Window w;
  w.lo = bounds[0];
  w.width = max(bounds[1] - w.lo, 0LL);
  w.staged = w.width <= WIN;
  if (w.staged) {
    for (long long k = threadIdx.x; k < w.width; k += ET) win[k] = csum[w.lo + k];
  }
  __syncthreads();
  return w;
}

// #{i : csum[i] <= j} for a slot j of this block.
__device__ __forceinline__ long long rank(const Window& w, const int* csum,
                                          const int* win, long long j) {
  return w.lo + (w.staged ? upper_bound(win, 0, w.width, j)
                          : upper_bound(csum + w.lo, 0, w.width, j));
}

// Blocks for n_out slots.
inline unsigned blocks_for(long long n_out) {
  return (unsigned)((n_out + ETILE - 1) / ETILE);
}

// Up to three u64 payload slots (the join's vcarry gate), passed by value.
constexpr int MAX_SLOTS = 3;
struct Slots {
  const long long* p[MAX_SLOTS];
};
struct SlotOuts {
  long long* p[MAX_SLOTS];
};

inline Slots slots_from(const long long* const* src, int n) {
  Slots s{};
  for (int k = 0; k < n; ++k) s.p[k] = src[k];
  return s;
}

inline SlotOuts outs_from(long long* const* dst, int n) {
  SlotOuts s{};
  for (int k = 0; k < n; ++k) s.p[k] = dst[k];
  return s;
}

}  // namespace dj_window
