// The hash partition's ids and counts: each row's partition id under
// murmur3 of its key columns, and the row count of each partition, in
// one pass over the keys.
//
// Replaces no TPU kernel: the JAX package's murmur3_32 and partition_ids
// (dj_tpu/ops/hashing.py:67, dj_tpu/ops/partition.py:30) are plain jnp,
// as was the port's (ops/partition.py::murmur3_partition_ids_plain): the
// hash in int64 lanes, each 32-bit multiply split in 16-bit halves, about
// 80 elementwise passes over an 8-byte key, then the modulo, the padding
// mask and a bincount. For cap rows of key columns c < ncols, each 1, 2,
// 4 or 8 bytes wide, a valid count and m partitions:
//   h[r] = murmur3(col 0 at r, seed), then h[r] = hash_combine(h[r],
//          murmur3(col c at r, seed)) for c = 1 .. ncols - 1, where a
//          float's -0.0 and subnormals hash as +0.0
//   pid[r] = h[r] % m for r < count, m for every padding row past it
//   counts[p] = the rows r < count with pid[r] == p
// bit for bit the plain version's (MurmurHash3_x86_32 of the element's
// little-endian bytes; cuDF's hash_combine).
//
// Bound on this card: bytes. Each key byte is read once and a 4-byte id
// written: 12 B a row for one int64 key, 1.2 GB and 0.36 ms at 3.35 TB/s
// for 100M rows. The hash is about 30 integer operations a row, far
// below the card's rate.
//
// Design: one grid-stride pass, a warp taking 128 rows a step. Lane l
// holds rows 2l, 2l + 1, 64 + 2l and 65 + 2l, so that each load of a key
// pair (16 B for an 8-byte key, down to 2 B for a 1-byte one) and each
// 8-byte store of an id pair is one fully coalesced warp instruction, for
// every width and any number of columns. The murmur3 arithmetic runs in
// 32-bit registers, where the multiplies wrap natively. The column
// pointers and kinds come in one device array, read through the
// read-only cache. The count is read from the device, so the host reads
// nothing. Counting: up to SMALL_M partitions each thread keeps its own
// counter a partition in shared memory (thread t's counter of p at
// p * NT + t: no two threads share a word, and a warp touches 32 banks),
// so m = 4 serialises on nothing; the block sums them a warp a
// partition and adds each sum to the output with one global atomic. Up
// to SHARED_M partitions the block counts in one shared histogram with
// shared atomics; past it each row adds to the output directly. Integer
// atomics keep the counts exact in any order. The counts are zeroed by
// one cudaMemsetAsync on the stream before the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int WARP_ROWS = 128;   // rows a warp takes a step
constexpr int SMALL_M = 32;      // m up to which each thread counts in its own words
constexpr int SHARED_M = 8192;   // m up to which a block counts in shared memory
constexpr int FLOAT_KIND = 16;   // a column's kind: its width, | FLOAT_KIND for a float

constexpr uint32_t C1 = 0xCC9E2D51u;
constexpr uint32_t C2 = 0x1B873593u;
constexpr uint32_t MIX1 = 0x85EBCA6Bu;
constexpr uint32_t MIX2 = 0xC2B2AE35u;
constexpr uint32_t N = 0xE6546B64u;
constexpr uint32_t GOLDEN = 0x9E3779B9u;  // hash_combine's constant

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k(uint32_t k) {
  return rotl32(k * C1, 15) * C2;
}

__device__ __forceinline__ uint32_t mix_block(uint32_t h, uint32_t k) {
  return rotl32(h ^ mix_k(k), 13) * 5u + N;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= MIX1;
  h ^= h >> 13;
  h *= MIX2;
  return h ^ (h >> 16);
}

// MurmurHash3_x86_32 of one element: lo and hi are its low and high
// 32-bit words (hi 0 below 8 bytes); a 1- or 2-byte element is the tail
// of an empty block stream, mixed without the h-rotate step.
__device__ __forceinline__ uint32_t murmur3(uint32_t lo, uint32_t hi, int width, uint32_t seed) {
  uint32_t h;
  if (width == 8) {
    h = mix_block(mix_block(seed, lo), hi) ^ 8u;
  } else if (width == 4) {
    h = mix_block(seed, lo) ^ 4u;
  } else {
    h = seed ^ mix_k(lo & (width == 1 ? 0xFFu : 0xFFFFu)) ^ (uint32_t)width;
  }
  return fmix32(h);
}

// The words of rows row and row + 1 of a column of the given width into
// (lo[0], hi[0]) and (lo[1], hi[1]): one load when vec (both rows exist
// and the pair is aligned), else a load a row below cap (0 past it).
__device__ __forceinline__ void load_pair(const unsigned char* p, int width, long long row,
                                          bool vec, long long cap, uint32_t lo[2],
                                          uint32_t hi[2]) {
  hi[0] = hi[1] = 0;
  if (vec) {
    if (width == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + 8 * row));
      lo[0] = v.x, hi[0] = v.y, lo[1] = v.z, hi[1] = v.w;
    } else if (width == 4) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + 4 * row));
      lo[0] = v.x, lo[1] = v.y;
    } else if (width == 2) {
      const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p + 2 * row));
      lo[0] = v & 0xFFFFu, lo[1] = v >> 16;
    } else {
      const unsigned v = __ldg(reinterpret_cast<const unsigned short*>(p + row));
      lo[0] = v & 0xFFu, lo[1] = v >> 8;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    lo[j] = 0;
    if (row + j >= cap) continue;
    const unsigned char* q = p + (row + j) * width;
    if (width == 8) {
      lo[j] = __ldg(reinterpret_cast<const unsigned*>(q));
      hi[j] = __ldg(reinterpret_cast<const unsigned*>(q) + 1);
    } else if (width == 4) {
      lo[j] = __ldg(reinterpret_cast<const unsigned*>(q));
    } else if (width == 2) {
      lo[j] = __ldg(reinterpret_cast<const unsigned short*>(q));
    } else {
      lo[j] = __ldg(q);
    }
  }
}

__global__ void __launch_bounds__(NT) partition_ids_kernel(
    const long long* __restrict__ cols, int ncols, const int* __restrict__ count,
    int* __restrict__ pid, int* __restrict__ counts, long long cap, unsigned m, unsigned seed) {
  // m <= SMALL_M: thread t's counter of partition p at p * NT + t;
  // m <= SHARED_M: the block's histogram; else unused.
  extern __shared__ int bins[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nbins = m <= SMALL_M ? (int)m * NT : m <= SHARED_M ? (int)m : 0;
  for (int i = threadIdx.x; i < nbins; i += NT) bins[i] = 0;
  __syncthreads();

  const long long valid = min(max((long long)*count, 0LL), cap);
  const long long step = (long long)gridDim.x * (NT / 32) * WARP_ROWS;
  for (long long base = ((long long)blockIdx.x * (NT / 32) + warp) * WARP_ROWS; base < cap;
       base += step) {
    const bool full = base + WARP_ROWS <= cap;
    const long long rows[2] = {base + 2 * lane, base + 64 + 2 * lane};
    uint32_t h[4] = {0, 0, 0, 0};
    for (int c = 0; c < ncols; ++c) {
      const unsigned char* p = reinterpret_cast<const unsigned char*>(__ldg(cols + c));
      const int kind = (int)__ldg(cols + ncols + c);
      const int width = kind & (FLOAT_KIND - 1);
      const bool vec = full && (reinterpret_cast<uintptr_t>(p) & (2 * width - 1)) == 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t lo[2], hi[2];
        load_pair(p, width, rows[half], vec, cap, lo, hi);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (kind & FLOAT_KIND) {
            // -0.0 and the subnormals (exponent field 0) hash as +0.0.
            const bool zero = width == 8 ? (hi[j] & 0x7FF00000u) == 0 : (lo[j] & 0x7F800000u) == 0;
            if (zero) lo[j] = hi[j] = 0;
          }
          const uint32_t x = murmur3(lo[j], hi[j], width, seed);
          uint32_t& acc = h[2 * half + j];
          acc = c == 0 ? x : acc ^ (x + GOLDEN + (acc << 6) + (acc >> 2));
        }
      }
    }
    int id[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long row = rows[k >> 1] + (k & 1);
      id[k] = (int)m;
      if (row < valid) {
        id[k] = (int)(h[k] % m);
        if (m <= SMALL_M) {
          ++bins[id[k] * NT + threadIdx.x];
        } else if (m <= SHARED_M) {
          atomicAdd(bins + id[k], 1);
        } else {
          atomicAdd(counts + id[k], 1);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = rows[half];
      if (full) {
        *reinterpret_cast<int2*>(pid + row) = make_int2(id[2 * half], id[2 * half + 1]);
      } else {
        if (row < cap) pid[row] = id[2 * half];
        if (row + 1 < cap) pid[row + 1] = id[2 * half + 1];
      }
    }
  }

  __syncthreads();
  if (m <= SMALL_M) {
    for (int p = warp; p < (int)m; p += NT / 32) {
      int s = 0;
#pragma unroll
      for (int k = 0; k < NT / 32; ++k) s += bins[p * NT + 32 * k + lane];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
      if (lane == 0 && s) atomicAdd(counts + p, s);
    }
  } else if (m <= SHARED_M) {
    for (int p = threadIdx.x; p < (int)m; p += NT) {
      if (bins[p]) atomicAdd(counts + p, bins[p]);
    }
  }
}

}  // namespace

// cols: device int64 [2 * ncols], the columns' data pointers then their
// kinds (width, | FLOAT_KIND for a float); count: device int32, the valid
// rows; pid: cap int32, 8-byte aligned; counts: m int32. Zeroes counts
// on the stream, then launches the kernel when cap > 0. Returns the
// first CUDA error, 0 when both were accepted.
extern "C" int dj_partition_ids(const long long* cols, int ncols, const int* count, int* pid,
                                int* counts, long long cap, int m, unsigned seed, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)m * sizeof(int), st);
  if (e != cudaSuccess || cap <= 0) return (int)e;
  const unsigned um = (unsigned)m;
  const size_t smem = (um <= SMALL_M ? um * NT : um <= SHARED_M ? um : 0) * sizeof(int);
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return (int)e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, partition_ids_kernel, NT, smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows_per_block = (long long)(NT / 32) * WARP_ROWS;
  const long long need = (cap + rows_per_block - 1) / rows_per_block;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(need < resident ? need : resident);
  partition_ids_kernel<<<blocks, NT, smem, st>>>(cols, ncols, count, pid, counts, cap, um, seed);
  return (int)cudaGetLastError();
}
