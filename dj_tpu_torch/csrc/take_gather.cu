// Gather through the L2 cache: the hardware probe's dynamic gather.
//
// Replaces the TPU kernel scripts/hw/probe_gather.py::run (kernel and
// pallas_call at probe_gather.py:19-35; its slope loop, probe_gather.py:
// 51-70, launches the same kernel at :59). For int32 vals and idx of N
// words, out[j] = jnp.take(vals, idx, axis=0)[j]: vals[idx[j]] for idx[j]
// in [0, N), vals[idx[j] + N] for idx[j] in [-N, 0), and INT32_MIN (the
// fill of jnp.take's default mode) for any other index.
//
// Bound on this card: bytes, 12 per element (idx and vals read, out
// written): 1.57 MB at the probe's N = 131072, 0.47 us at 3.35 TB/s.
// That is below the overhead of one launch, so one launch's time says
// little; the probe's slope timing (iterations of a chained loop, each
// gathering at the last one's result) is the number to read.
//
// Design: the TPU kernel holds vals whole in VMEM and gathers from it.
// On this card the 50 MB L2 cache plays that part by itself: vals (512
// KB at the probe's N) is read from device memory once and every later
// read of it hits L2, so no shared-memory stage, cluster or barrier is
// needed (csrc/cluster_gather.cu, which stages vals across a cluster's
// shared memory, measured slower: launching 8-CTA clusters with their
// barriers and reading through distributed shared memory cost more than
// the L2 reads they replace). Each thread takes 4 consecutive indices:
// one 16-byte load of idx, four independent reads of vals through the
// read-only path (__ldg: L1, then L2), one 16-byte store of out. The
// wrap and fill rule is applied in registers. The grid covers N = 131072
// in one pass (128 CTAs of 256 threads) and strides over larger N. When
// idx or out is not 16-byte aligned, every index takes the scalar path,
// as do the last N % 4 indices.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 256;            // threads per CTA
constexpr int MAX_CTAS = 132 * 8; // 8 CTAs of 256 threads on each of 132 SMs
constexpr int FILL = INT_MIN;

__device__ __forceinline__ int take1(const int* __restrict__ vals, int i, long long n) {
  long long v = i;
  if (v < 0) v += n;  // [-N, 0) wraps; anything below stays negative
  return v >= 0 && v < n ? __ldg(vals + v) : FILL;
}

__global__ void __launch_bounds__(T)
take_gather_kernel(const int* __restrict__ vals, const int* __restrict__ idx,
                   int* __restrict__ out, long long n, long long nvec) {
  const long long stride = (long long)gridDim.x * T;
  const long long tid = (long long)blockIdx.x * T + threadIdx.x;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long q = tid; q < nvec; q += stride) {
    const int4 i = __ldg(idx4 + q);
    out4[q] = make_int4(take1(vals, i.x, n), take1(vals, i.y, n), take1(vals, i.z, n),
                        take1(vals, i.w, n));
  }
  for (long long j = 4 * nvec + tid; j < n; j += stride) out[j] = take1(vals, __ldg(idx + j), n);
}

}  // namespace

// vals, idx, out: n int32 words, n >= 1. Returns the CUDA error of the
// launch, 0 when it was accepted.
extern "C" int dj_take_gather(const int* vals, const int* idx, int* out, long long n,
                              void* stream) {
  if (n <= 0) return 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const long long nvec = aligned ? n / 4 : 0;
  const long long work = nvec > 0 ? nvec : n;
  long long ctas = (work + T - 1) / T;
  if (ctas > MAX_CTAS) ctas = MAX_CTAS;
  take_gather_kernel<<<(unsigned)ctas, T, 0, (cudaStream_t)stream>>>(vals, idx, out, n, nvec);
  return (int)cudaGetLastError();
}
