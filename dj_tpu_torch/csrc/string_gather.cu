// The char gather of a string column's take: each output byte of the
// gathered rows.
//
// Replaces no TPU kernel: the JAX package's StringColumn.take
// (dj_tpu/core/table.py:77-108) is plain jnp, as was the port's
// (ops/strings.py::string_gather_plain): a search of the new offsets for
// each of the cap output bytes, then gathers. For n gathered rows with
// new_offsets (n + 1 int32, ascending from 0), starts (n int32, each
// row's first source byte) and each output byte j < cap:
//   out[j] = chars[s], s = starts[r] + j - new_offsets[r] (int32 wrap),
//            for j < new_offsets[n], r the row with
//            new_offsets[r] <= j < new_offsets[r + 1]; 0 where s lies
//            outside chars
//   out[j] = 0 for j >= new_offsets[n]
// byte for byte the plain version's. Offsets that wrapped past 2^31 are
// not ascending; their bytes are then unspecified, and nothing outside
// the inputs and out[0, cap) is read or written.
//
// Bound on this card: bytes. new_offsets and starts are read (8 B a
// row), each gathered row's bytes once, and cap bytes written. At TPC-H
// SF 100's split (75M rows of O_ORDERPRIORITY, about 630M bytes into a
// cap of 787.5M) that is about 2.0 GB, 0.6 ms at the memory rate of an
// H100 SXM; the source rows are read at random, a 32-byte sector at a
// time, so the card moves more.
//
// Design: the merge-path window of csrc/expand_window.cuh over the
// output bytes, with no search per byte. Each block owns TILE
// consecutive output bytes; a block at or past new_offsets[n] writes
// zeros and searches nothing. Two warps find the block's first and last
// row by warp-wide searches of new_offsets (32 probes a step: about six
// dependent loads over 75M rows, where a binary search takes 27). Each
// non-empty row of that window marks the byte where it starts, in a
// shared array of the tile's bytes, and the first row marks byte 0; a
// block-wide max-scan of the marks gives every byte its row (an empty
// row owns no byte and marks none, so a run of them costs one pass over
// its offsets and nothing more). The block stages each row's starts[r] -
// new_offsets[r] in shared memory; a window of more than WIN rows (a
// long run of empty rows, from out-of-range indices) reads both from
// global memory instead, so every byte is exact for every window and
// row length. Lane l of warp w then takes the output bytes w * 512 +
// 32 e + l, e < VB, so each load instruction of a warp reads 32
// consecutive output bytes: a few neighbouring rows and a few source
// sectors. The warp's 512 bytes meet in shared memory and leave as one
// aligned 16-byte store a lane, so the output, zero tail included, is
// written once, coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;              // threads per block
constexpr int VB = 16;               // output bytes per thread
constexpr int TILE = NT * VB;        // output bytes per block
constexpr int WARP_BYTES = 32 * VB;  // output bytes per warp
constexpr int WIN = 4096;            // rows whose source base a block stages

// First index in [lo, hi) whose value exceeds v (hi if none), found by
// the whole warp, every lane active: each step probes 32 evenly spaced
// entries and keeps the gap between the last one <= v and the next.
// Every lane returns the same index, in [lo, hi] for any input.
__device__ long long warp_upper_bound(const int* a, long long lo, long long hi,
                                      long long v) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const bool le = (long long)a[lo + span * (lane + 1) / 33] <= v;
    const int t = __popc(__ballot_sync(0xffffffffu, le));
    const long long nlo = t > 0 ? lo + span * t / 33 + 1 : lo;
    hi = t < 32 ? lo + span * (t + 1) / 33 : hi;
    lo = nlo;
  }
  const bool le = lo + lane < hi && (long long)a[lo + lane] <= v;
  return lo + __popc(__ballot_sync(0xffffffffu, le));
}

__global__ void __launch_bounds__(NT) string_gather_kernel(
    const int* __restrict__ new_offsets, const int* __restrict__ starts,
    const unsigned char* __restrict__ chars, unsigned char* __restrict__ out, long long n,
    long long nchars, long long cap) {
  // Each byte's row in the window (marks, then their max-scan); then,
  // its first TILE bytes, the tile of output bytes.
  __shared__ __align__(16) int row_at[TILE];
  __shared__ int base[WIN];  // starts[r] - new_offsets[r], r in the window
  __shared__ long long rows[2];
  __shared__ int warp_max[NT / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long j0 = (long long)blockIdx.x * TILE;
  const long long total = new_offsets[n];
  if (j0 >= total) {
    const long long j = j0 + (long long)threadIdx.x * VB;
    if (j + VB <= cap) {
      *reinterpret_cast<uint4*>(out + j) = make_uint4(0, 0, 0, 0);
    } else {
      for (long long i = j; i < cap; ++i) out[i] = 0;
    }
    return;
  }
  const long long j_end = min(min(j0 + TILE, cap), total);
  if (warp < 2) {
    const long long r = warp_upper_bound(new_offsets, 0, n + 1, warp == 0 ? j0 : j_end - 1) - 1;
    if (lane == 0) rows[warp] = r;
  }
  int4* marks = reinterpret_cast<int4*>(row_at) + threadIdx.x * (VB / 4);
#pragma unroll
  for (int q = 0; q < VB / 4; ++q) marks[q] = make_int4(-1, -1, -1, -1);
  __syncthreads();
  const long long lo = max(min(rows[0], n - 1), 0LL);
  const long long nrows = max(min(rows[1], n - 1), lo) - lo + 1;
  const bool staged = nrows <= WIN;
  for (long long k = threadIdx.x; k < nrows; k += NT) {
    const int s = new_offsets[lo + k];
    if (staged) base[k] = (int)((unsigned)starts[lo + k] - (unsigned)s);
    if (k > 0 && new_offsets[lo + k + 1] > s && s > j0 && s < j0 + TILE) row_at[s - j0] = (int)k;
  }
  if (threadIdx.x == 0) row_at[0] = 0;
  __syncthreads();

  // Inclusive max-scan of the marks: VB bytes a thread, then the warps.
  int r[VB];
  int m = -1;
#pragma unroll
  for (int q = 0; q < VB / 4; ++q) {
    const int4 v = marks[q];
    r[4 * q] = m = max(m, v.x);
    r[4 * q + 1] = m = max(m, v.y);
    r[4 * q + 2] = m = max(m, v.z);
    r[4 * q + 3] = m = max(m, v.w);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, m, d);
    if (lane >= d) m = max(m, y);
  }
  if (lane == 31) warp_max[warp] = m;
  int carry = __shfl_up_sync(0xffffffffu, m, 1);
  if (lane == 0) carry = -1;
  __syncthreads();
  for (int w = 0; w < warp; ++w) carry = max(carry, warp_max[w]);
#pragma unroll
  for (int q = 0; q < VB / 4; ++q) {
    marks[q] = make_int4(max(carry, r[4 * q]), max(carry, r[4 * q + 1]),
                         max(carry, r[4 * q + 2]), max(carry, r[4 * q + 3]));
  }
  __syncthreads();

  // Each byte's source, lane-strided over the warp's slice.
  const long long jw = j0 + (long long)warp * WARP_BYTES;
  int src[VB];
#pragma unroll
  for (int e = 0; e < VB; ++e) {
    const int p = warp * WARP_BYTES + e * 32 + lane;
    const long long j = j0 + p;
    src[e] = -1;
    if (j < j_end) {
      const int k = row_at[p];
      const unsigned b = staged ? (unsigned)base[k]
                                : (unsigned)starts[lo + k] - (unsigned)new_offsets[lo + k];
      src[e] = (int)(b + (unsigned)j);
    }
  }
  __syncthreads();  // row_at becomes the tile of output bytes
  unsigned char* tw = reinterpret_cast<unsigned char*>(row_at) + warp * WARP_BYTES;
#pragma unroll
  for (int e = 0; e < VB; ++e) {
    const int s = src[e];
    tw[e * 32 + lane] = (s >= 0 && s < nchars) ? chars[s] : (unsigned char)0;
  }
  __syncwarp();
  const long long j = jw + lane * VB;
  if (j + VB <= cap) {
    *reinterpret_cast<uint4*>(out + j) = *reinterpret_cast<const uint4*>(tw + lane * VB);
  } else {
    for (long long i = j; i < cap; ++i) out[i] = tw[lane * VB + (i - j)];
  }
}

}  // namespace

// new_offsets: n + 1 int32; starts: n int32; chars: nchars bytes; out:
// cap bytes, 16-byte aligned. Returns the CUDA error of the launch, 0
// when accepted.
extern "C" int dj_string_gather(const int* new_offsets, const int* starts,
                                const unsigned char* chars, unsigned char* out, long long n,
                                long long nchars, long long cap, void* stream) {
  if (cap <= 0) return 0;
  string_gather_kernel<<<(unsigned)((cap + TILE - 1) / TILE), NT, 0, (cudaStream_t)stream>>>(
      new_offsets, starts, chars, out, n, nchars, cap);
  return (int)cudaGetLastError();
}
