"""Probe: where does the cluster gather's time go on the card?

Builds variants of ``csrc/cluster_gather.cu`` (each one change to its
text: block size, cluster size, how many clusters, the staging loop, the
remote reads) and a plain gather kernel with no cluster, and times each
beside ``run`` (the L2 gather of ``csrc/take_gather.cu``) and
``vals[idx]`` at the probe's N: one launch and one iteration of
the slope loop from CUDA graphs (``probe_gather.graph_ms``), and the
kernels' own device time from ``torch.profiler``. Variants marked
"timing only" give wrong values and are not compared.

Run on the card:  python -m dj_tpu_torch.hw.gather_variants
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_build
from . import probe_gather

SOURCE = cuda_build.CSRC / "cluster_gather.cu"
STAGE = "for (int i = threadIdx.x; i < cnt; i += T) part[i] = vals[base + i];"
REMOTE = "r = cluster.map_shared_rank(part, v / share)[v % share];"
CLUSTERS = "const long long clusters = wanted < resident ? wanted : resident;"
UNROLLED = """for (int i0 = threadIdx.x; i0 < cnt; i0 += T * 16) {
    int w[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) w[u] = i0 + u * T < cnt ? vals[base + i0 + u * T] : 0;
#pragma unroll
    for (int u = 0; u < 16; ++u) if (i0 + u * T < cnt) part[i0 + u * T] = w[u];
  }"""
PLAIN = r"""
#include <cuda_runtime.h>
__global__ void plain_gather(const int* __restrict__ vals, const int* __restrict__ idx,
                             int* __restrict__ out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int v = idx[j];
  if (v < 0) v += n;
  out[j] = v >= 0 && v < n ? vals[v] : -2147483647 - 1;
}
extern "C" int dj_cluster_gather(const int* vals, const int* idx, int* out, long long n,
                                 void* stream) {
  plain_gather<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(vals, idx, out, (int)n);
  return (int)cudaGetLastError();
}
"""
# name: ((old, new) replacements in the source, whether its values are right)
VARIANTS = {
    "as built (8 CTAs of 1024 threads)": ((), True),
    "staging unrolled 16 deep": (((STAGE, UNROLLED),), True),
    "256 threads a CTA": ((("constexpr int T = 1024;", "constexpr int T = 256;"),), True),
    "4 CTAs a cluster": ((("constexpr int C = 8; ", "constexpr int C = 4; "),), True),
    "every resident cluster": (((CLUSTERS, "const long long clusters = resident;"),), True),
    "one cluster": (((CLUSTERS, "const long long clusters = 1;"),), True),
    "one CTA an SM (116 KB requested)": (((
        "const int smem = (int)(share * sizeof(int));",
        "const int smem = share * (long long)sizeof(int) > 118784 ? (int)(share * sizeof(int)) : 118784;"),), True),
    "own CTA's memory only (timing only)": (((REMOTE, "r = part[v % share];"),), False),
    "no staging, reads device memory": (((STAGE, ""), (REMOTE, "r = vals[v];")), True),
}


def _sources(text: str) -> dict[str, tuple[str, bool]]:
    out = {}
    for name, (edits, right) in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in {SOURCE.name}")
            src = src.replace(old, new)
        out[name] = (src, right)
    out["plain gather, no cluster"] = (PLAIN, True)
    return out


def _build(sources: dict) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all at once, as cuda_build does."""
    out_dir = cuda_build.BUILD_DIR / "gather_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, (src, _)) in enumerate(sources.items()):
        cu, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(src)
        cmd = [cuda_build._nvcc(), *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(lib), str(cu)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _gather(lib: ctypes.CDLL):
    fn = lib.dj_cluster_gather
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def gather(vals, idx):
        out = torch.empty_like(vals)
        rc = fn(vals.data_ptr(), idx.data_ptr(), out.data_ptr(), vals.numel(),
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check(rc, "gather variant")
        return out

    return gather


def kernel_us(fn, reps: int) -> dict[str, float]:
    """Device time of each kernel ``fn`` launches, us per call, from the
    profiler over one replay of a CUDA graph of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.device_time_total / reps
    return by_name


def main(argv=None) -> dict:
    """Times every variant; prints one line each and returns {name: {...}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=probe_gather.N)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("gather_variants: no CUDA device")
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}")
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.integers(0, 1 << 30, args.n, dtype=np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, args.n, args.n, dtype=np.int32)).to(dev)
    want = probe_gather.run_plain(vals, idx)
    sources = _sources(SOURCE.read_text())
    libs = _build(sources)
    variants = {name: (_gather(libs[name]), right) for name, (_, right) in sources.items()}
    variants["run: L2 gather (csrc/take_gather.cu)"] = (probe_gather.run, True)
    variants["vals[idx]"] = (lambda v, i: v[i], True)
    res = {}
    for name, (gather, right) in variants.items():
        if right and not torch.equal(gather(vals, idx), want):
            raise AssertionError(f"{name}: differs from the plain version")
        one = probe_gather.graph_ms(lambda: gather(vals, idx), args.reps)
        t1 = probe_gather.graph_ms(lambda: probe_gather.loop(vals, idx, 1, gather), args.reps)
        t17 = probe_gather.graph_ms(lambda: probe_gather.loop(vals, idx, 17, gather), args.reps)
        res[name] = {"launch_us": one * 1e3, "slope_us": (t17 - t1) / 16 * 1e3,
                     "kernel_us": kernel_us(lambda: gather(vals, idx), args.reps)}
        r = res[name]
        kernels = ", ".join(f"{k} {v:.3f}" for k, v in r["kernel_us"].items())
        print(f"{name}: one launch {r['launch_us']:.3f} us, slope {r['slope_us']:.3f} us/iter; "
              f"kernels (us): {kernels}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
