// Sort of each tile of a u32 array: the hardware probe's tile sort.
//
// Replaces the TPU kernel scripts/hw/probe_sort.py::tile_sort (kernel and
// pallas_call at probe_sort.py:19-32): x holds NT tiles of TILE words,
// and out holds each tile sorted ascending as unsigned 32-bit words,
// equal to np.sort(x.reshape(NT, TILE), axis=1).
//
// Bound on this card: bytes, 4 read and 4 written per word (at the
// probe's NT = 64, TILE = 32768: 16.8 MB, 5 us at 3.35 TB/s). A sort is
// not bounded by bytes alone: a bitonic network does log2 P (log2 P + 1)
// / 2 compare-exchange stages over the tile (120 at P = 32768), and the
// stages set its time long before device memory does. The probe's 64
// tiles fill only 64 of the 132 SMs; at the join's scale (6104 tiles)
// every SM runs a tile at a time.
//
// Design: one block per tile, each stage of the bitonic network placed
// where its stride lives. A tile is padded with 0xFFFFFFFF to
// P = max(next power of two >= TILE, 32 E) words (pads sort last and are
// never written back, so any TILE takes the same path), and thread t of
// the P / E threads holds words [t E, t E + E) in registers (E = 32; at
// P = 32768, 1024 threads). The network is the one whose first stage of
// each merge of size k compares i with its mirror i ^ (k - 1) and whose
// later stages compare i with i + j, always ascending, so no stage needs
// a direction bit:
//   - strides below E are compare-exchanges between a thread's own
//     registers, unrolled so that every register index is a constant;
//   - strides from E to 16 E pair two lanes of one warp
//     (__shfl_xor_sync), each keeping the minimum or the maximum; the
//     merges that fit in a warp (k <= 32 E, every tile has them) are
//     unrolled whole, so every lane mask is a constant too;
//   - only strides of 32 E and above (k > 32 E) go through shared memory,
//     with a block barrier after each stage.
// At P = 32768 that is 65 stages in registers, 40 in shuffles and 15
// through shared memory, where the first design ran all 120 through
// shared memory; ptxas keeps it in 64 registers a thread (the limit at
// 1024 threads) with no spill. Shared memory holds the tile with one pad
// word after every 32 (135 KB at P = 32768, above the 48 KB a launch gets by
// default, so the entry raises the kernel's limit first), so that a
// thread's E consecutive words and a warp's consecutive words both fall
// in distinct banks.

#include <cuda_runtime.h>

namespace {

constexpr int E = 32;                // words a thread holds in registers
constexpr int WARP_WORDS = 32 * E;   // words a warp holds: the smallest P
constexpr int MAX_TILE = 32768;
constexpr int MAX_T = MAX_TILE / E;  // threads of the largest tile
constexpr unsigned FULL = 0xFFFFFFFFu;

// Shared-memory slot of word i: one pad word after every 32.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ void cas(unsigned& a, unsigned& b) {
  const unsigned lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// Ascending stages j = E/2, ..., 1 between a thread's registers.
__device__ __forceinline__ void register_stages(unsigned (&v)[E]) {
#pragma unroll
  for (int j = E / 2; j > 0; j >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (!(e & j)) cas(v[e], v[e + j]);
    }
  }
}

// Each thread's E words sorted: the merges k = 2, ..., E in registers.
__device__ __forceinline__ void sort_registers(unsigned (&v)[E]) {
#pragma unroll
  for (int k = 2; k <= E; k <<= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (!(e & (k >> 1))) cas(v[e], v[e ^ (k - 1)]);
    }
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (!(e & j)) cas(v[e], v[e + j]);
      }
    }
  }
}

// The mirror stage of a merge of k = (m + 1) E words, 2 <= m + 1 <= 32:
// register r pairs with register E - 1 - r of lane ^ m; the lane whose
// word comes first keeps the minimum.
__device__ __forceinline__ void shuffle_mirror(unsigned (&v)[E], int m, bool first) {
#pragma unroll
  for (int r = 0; r < E / 2; ++r) {
    const unsigned o_lo = __shfl_xor_sync(FULL, v[E - 1 - r], m);
    const unsigned o_hi = __shfl_xor_sync(FULL, v[r], m);
    v[r] = first ? min(v[r], o_lo) : max(v[r], o_lo);
    v[E - 1 - r] = first ? min(v[E - 1 - r], o_hi) : max(v[E - 1 - r], o_hi);
  }
}

// An ascending stage of stride m E, m < 32: register r pairs with
// register r of lane ^ m.
__device__ __forceinline__ void shuffle_stage(unsigned (&v)[E], int m, bool first) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const unsigned o = __shfl_xor_sync(FULL, v[r], m);
    v[r] = first ? min(v[r], o) : max(v[r], o);
  }
}

// One stage in shared memory over the P / 2 pairs, E / 2 a thread: the
// mirror stage of a merge of k words (mirror) or the ascending stage of
// stride k (otherwise).
__device__ __forceinline__ void shared_stage(unsigned* s, int k, bool mirror, int nthreads) {
#pragma unroll 4
  for (int x = 0; x < E / 2; ++x) {
    const int q = threadIdx.x + x * nthreads;
    int i, partner;
    if (mirror) {
      const int h = k >> 1;
      i = ((q & ~(h - 1)) << 1) | (q & (h - 1));
      partner = i ^ (k - 1);
    } else {
      i = 2 * q - (q & (k - 1));
      partner = i + k;
    }
    const unsigned a = s[pad(i)], b = s[pad(partner)];
    if (a > b) {
      s[pad(i)] = b;
      s[pad(partner)] = a;
    }
  }
}

__global__ void __launch_bounds__(MAX_T)
tile_sort_kernel(const unsigned* x, unsigned* out, int tile, int p) {
  extern __shared__ unsigned s[];
  const int t = threadIdx.x, lane = t & 31, nthreads = blockDim.x;
  const unsigned* in = x + (long long)blockIdx.x * tile;
  for (int i = t; i < p; i += nthreads) s[pad(i)] = i < tile ? in[i] : FULL;
  __syncthreads();
  unsigned v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) v[r] = s[pad(t * E + r)];
  sort_registers(v);
  // Merges within a warp (every tile has P >= 32 E): k = kw E.
#pragma unroll
  for (int kw = 2; kw <= 32; kw <<= 1) {
    shuffle_mirror(v, kw - 1, !(lane & (kw >> 1)));
#pragma unroll
    for (int m = kw >> 2; m > 0; m >>= 1) shuffle_stage(v, m, !(lane & m));
    register_stages(v);
  }
  // Merges across warps: the long strides through shared memory.
  for (int k = 2 * WARP_WORDS; k <= p; k <<= 1) {
    __syncthreads();  // every thread has read s since it was last written
#pragma unroll
    for (int r = 0; r < E; ++r) s[pad(t * E + r)] = v[r];
    __syncthreads();
    shared_stage(s, k, true, nthreads);
    __syncthreads();
    for (int j = k >> 2; j >= WARP_WORDS; j >>= 1) {
      shared_stage(s, j, false, nthreads);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = s[pad(t * E + r)];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) shuffle_stage(v, m, !(lane & m));
    register_stages(v);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < E; ++r) s[pad(t * E + r)] = v[r];
  __syncthreads();
  unsigned* dst = out + (long long)blockIdx.x * tile;
  for (int i = t; i < tile; i += nthreads) dst[i] = s[pad(i)];
}

}  // namespace

// x, out: nt * tile u32 words, 1 <= tile <= 32768. Returns the CUDA error
// of setting the shared-memory limit or of the launch, 0 when accepted.
extern "C" int dj_tile_sort(const unsigned* x, unsigned* out, long long nt,
                            int tile, void* stream) {
  if (nt <= 0) return 0;
  if (tile < 1 || tile > MAX_TILE) return (int)cudaErrorInvalidValue;
  int p = WARP_WORDS;
  while (p < tile) p <<= 1;
  const int smem = (p + p / 32) * (int)sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tile_sort_kernel<<<(unsigned)nt, p / E, smem, (cudaStream_t)stream>>>(x, out, tile, p);
  return (int)cudaGetLastError();
}
