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
// / 2 compare-exchange stages over the tile (120 at P = 32768), each a
// pass over shared memory, so the shared-memory rate and the barriers
// between stages set its time long before device memory does. The
// probe's 64 tiles fill only 64 of the 132 SMs; at the join's scale
// (6104 tiles) every SM runs a tile at a time.
//
// Design: one block of 1024 threads per tile. The TPU kernel sorts a
// tile held in VMEM; Hopper's fast memory is the 227 KB shared memory
// of an SM, and one 32768-word tile (128 KB) fits it whole. The block
// stages the tile in dynamic shared memory, padded to a power of two P
// with 0xFFFFFFFF (pads sort last and are never written back, so any
// TILE works), runs the in-place bitonic network with a __syncthreads()
// between stages (each thread exchanges P / 2048 pairs a stage), and
// writes the first TILE words back. 128 KB is above the 48 KB a launch
// gets by default, so the entry raises the kernel's dynamic shared
// memory limit first. A double-buffered radix pass would need 2 x 128
// KB, which does not fit.

#include <cuda_runtime.h>

namespace {

constexpr int T = 1024;            // threads per block
constexpr int MAX_TILE = 32768;    // 128 KB of shared memory

__global__ void __launch_bounds__(T)
tile_sort_kernel(const unsigned* x, unsigned* out, int tile, int p) {
  extern __shared__ unsigned s[];
  const long long base = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < p; i += T) s[i] = i < tile ? x[base + i] : 0xFFFFFFFFu;
  __syncthreads();
  const int half = p >> 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < half; q += T) {
        // Pair q of the stage: i = (q / j) * 2j + q % j and i + j.
        const int i = 2 * q - (q & (j - 1));
        const unsigned a = s[i], b = s[i + j];
        const bool ascending = (i & k) == 0;
        if ((a > b) == ascending) {
          s[i] = b;
          s[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += T) out[base + i] = s[i];
}

}  // namespace

// x, out: nt * tile u32 words, 1 <= tile <= 32768. Returns the CUDA error
// of setting the shared-memory limit or of the launch, 0 when accepted.
extern "C" int dj_tile_sort(const unsigned* x, unsigned* out, long long nt,
                            int tile, void* stream) {
  if (nt <= 0) return 0;
  if (tile < 1 || tile > MAX_TILE) return (int)cudaErrorInvalidValue;
  int p = 1;
  while (p < tile) p <<= 1;
  const int smem = p * (int)sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tile_sort_kernel<<<(unsigned)nt, T, smem, (cudaStream_t)stream>>>(x, out, tile, p);
  return (int)cudaGetLastError();
}
