// Gather from fast memory: the hardware probe's dynamic gather.
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
// vals (512 KB at the probe's N) is more than one SM's 227 KB of shared
// memory, so the kernel runs as thread-block clusters of C = 8 CTAs
// (cudaLaunchKernelEx with a cluster dimension) and holds vals across
// the cluster's shared memory: CTA r stages vals[r * share, (r + 1) *
// share), share = ceil(N / C), then cluster.sync(). Each thread reads
// its indices from device memory and fetches each value from the owning
// CTA's shared memory through distributed shared memory
// (cluster.map_shared_rank). A second cluster.sync() keeps every CTA
// resident until no other CTA of its cluster still reads its memory.
// Several clusters, each with its own copy of vals, split the idx range,
// so that more than C SMs work: as many as need a thread per index, at
// most as many as can be resident at once. N is at most C * 227 KB / 4
// = 464896 words.
//
// Entry point: hw/probe_gather.py::run_cluster, on no path. The probe's
// run takes csrc/take_gather.cu, a plain gather through L2, which is
// faster on this card; this kernel stays as the subject of
// hw/gather_variants.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int C = 8;                          // CTAs per cluster
constexpr int T = 1024;                       // threads per CTA
constexpr int MAX_SHARE_BYTES = 232448;       // 227 KB: one CTA's shared memory
constexpr int FILL = -2147483647 - 1;         // INT32_MIN

__global__ void __launch_bounds__(T)
cluster_gather_kernel(const int* __restrict__ vals, const int* __restrict__ idx,
                      int* __restrict__ out, int n, int share, long long chunk) {
  extern __shared__ int part[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int base = rank * share;
  const int cnt = max(0, min(share, n - base));
  for (int i = threadIdx.x; i < cnt; i += T) part[i] = vals[base + i];
  cluster.sync();
  const long long j0 = (long long)(blockIdx.x / C) * chunk;
  const long long j1 = min(j0 + chunk, (long long)n);
  for (long long j = j0 + (long long)rank * T + threadIdx.x; j < j1; j += (long long)C * T) {
    int v = idx[j];
    if (v < 0) v += n;  // [-N, 0) wraps; anything below stays negative
    int r = FILL;
    if (v >= 0 && v < n) r = cluster.map_shared_rank(part, v / share)[v % share];
    out[j] = r;
  }
  cluster.sync();
}

}  // namespace

// vals, idx, out: n int32 words, 1 <= n <= C * MAX_SHARE_BYTES / 4.
// Returns the CUDA error of the set-up or the launch (or
// cudaErrorLaunchOutOfResources when no cluster can be resident), 0 when
// the launch was accepted.
extern "C" int dj_cluster_gather(const int* vals, const int* idx, int* out,
                                 long long n, void* stream) {
  if (n <= 0) return 0;
  const long long share = (n + C - 1) / C;
  if (share * (long long)sizeof(int) > MAX_SHARE_BYTES) return (int)cudaErrorInvalidValue;
  const int smem = (int)(share * sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      cluster_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, cluster_gather_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (resident < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long wanted = (n + (long long)C * T - 1) / ((long long)C * T);
  const long long clusters = wanted < resident ? wanted : resident;
  const long long chunk = (n + clusters - 1) / clusters;
  cfg.gridDim = dim3((unsigned)(clusters * C));
  err = cudaLaunchKernelEx(&cfg, cluster_gather_kernel, vals, idx, out, (int)n,
                           (int)share, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
