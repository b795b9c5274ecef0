"""Probe: is a dynamic gather from fast memory possible and fast on the card?

Counterpart of ``scripts/hw/probe_gather.py``. That probe asks whether a
TPU kernel can gather from VMEM by a runtime index vector. On the card
two kernels answer it. ``run`` launches ``csrc/take_gather.cu``, a plain
gather whose values stay in the 50 MB L2 cache after their first read;
``run_cluster`` launches ``csrc/cluster_gather.cu``, which holds the
values across the shared memory of a thread-block cluster (the study of
``hw/gather_variants.py``; no path uses it). Each takes the plain
version, ``run_plain``, for tensors on the CPU. All compute
``jnp.take(vals, idx, axis=0)`` in its default mode: an index in [-N, 0)
wraps, one outside [-N, N) gives INT32_MIN.

On the card the times come from CUDA graphs replayed between two
events: one launch takes a few microseconds, less than PyTorch needs
to issue it, so issuing launches one by one would time the host. A
replayed graph launches the kernel without calling the wrapper, so
``launches`` and ``cluster_launches`` count the captured calls, not the
replays.

Run on the card:  python -m dj_tpu_torch.hw.probe_gather
On the CPU (checks only, no timing):  ... --device cpu --n 1024
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time

import numpy as np
import torch

from ..ops import cuda_build

N = 131_072  # values and indices (the JAX probe's)
CLUSTER = 8  # CTAs per cluster (csrc/cluster_gather.cu)
MAX_N = CLUSTER * 232_448 // 4  # vals across the cluster's 227 KB per CTA
INT32_MIN = -(2**31)

launches = 0  # kernel launches made by run
cluster_launches = 0  # kernel launches made by run_cluster


def _check(vals: torch.Tensor, idx: torch.Tensor) -> int:
    """N; raises unless vals and idx are 1-D int32 of one length N >= 1
    on one device, the CPU or a CUDA card."""
    for name, t in (("vals", vals), ("idx", idx)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"run: {name} must be 1-D int32, got {t.dtype} {tuple(t.shape)}")
    n = vals.shape[0]
    if idx.shape[0] != n or n == 0:
        raise ValueError(f"run: vals and idx must have one length N >= 1, got {n} and {idx.shape[0]}")
    if vals.device != idx.device:
        raise ValueError(f"run: vals is on {vals.device}, idx on {idx.device}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"run: unsupported device {vals.device}")
    return n


def run_plain(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch formulation: vals at idx mod N where idx lies in
    [-N, N), INT32_MIN elsewhere."""
    n = _check(vals, idx)
    at = vals[torch.remainder(idx.to(torch.int64), n)]
    return torch.where((idx >= -n) & (idx < n), at, INT32_MIN)


def _launch(kernel: str, symbol: str, vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if not (vals.is_contiguous() and idx.is_contiguous()):
        raise ValueError("run: vals and idx must be contiguous")
    out = torch.empty_like(vals)
    fn = getattr(cuda_build.load(kernel), symbol)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(vals.data_ptr(), idx.data_ptr(), out.data_ptr(), vals.shape[0],
            torch.cuda.current_stream(vals.device).cuda_stream)
    cuda_build.check(rc, kernel)
    return out


def run(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(vals, idx, axis=0)``, (N,) int32; the L2 gather kernel
    on the card, the plain version on the CPU."""
    _check(vals, idx)
    if vals.device.type == "cpu":
        return run_plain(vals, idx)
    global launches
    launches += 1
    return _launch("take_gather", "dj_take_gather", vals, idx)


def run_cluster(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``run`` through the cluster gather kernel, which holds vals across
    a cluster's shared memory (N <= MAX_N); the plain version on the
    CPU."""
    n = _check(vals, idx)
    if vals.device.type == "cpu":
        return run_plain(vals, idx)
    if n > MAX_N:
        raise ValueError(f"run_cluster: N = {n} words ({4 * n} B) exceed a cluster's shared memory "
                         f"({CLUSTER} x 227 KB, N <= {MAX_N})")
    global cluster_launches
    cluster_launches += 1
    return _launch("cluster_gather", "dj_cluster_gather", vals, idx)


def loop(vals: torch.Tensor, idx: torch.Tensor, k: int, gather=run) -> torch.Tensor:
    """k chained gathers, i <- (i + gather(vals, i)) % N from i = idx (the
    JAX probe's slope loop, int32 arithmetic); returns the last i."""
    n = vals.shape[0]
    i = idx
    for _ in range(k):
        i = torch.remainder(i + gather(vals, i), n)
    return i


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a
    CUDA graph (after one warm-up call on a side stream), replayed three
    times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def main(argv=None) -> dict:
    """Check run and run_cluster (where N <= MAX_N) against numpy and, on
    the card, time each (one launch, and per iteration of the chained
    loop by the slope (t(17) - t(1)) / 16) beside the library gather
    ``vals[idx]``; prints CORRECT and the times, and returns {"n", "ms",
    "slope_ms", "cluster_ms", "cluster_slope_ms", "library_ms",
    "library_slope_ms"} (times in ms, on the card only)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_gather: no CUDA device (pass --device cpu to check on the CPU)")
    n = args.n
    rng = np.random.default_rng(args.seed)
    vals_np = rng.integers(0, 1 << 30, n, dtype=np.int32)
    idx_np = rng.integers(0, n, n, dtype=np.int32)
    vals, idx = torch.from_numpy(vals_np).to(dev), torch.from_numpy(idx_np).to(dev)
    gathers = {"": ("L2 gather (run)", run),
               "cluster_": ("cluster gather (run_cluster)", run_cluster),
               "library_": ("library vals[idx]", lambda v, i: v[i])}
    if n > MAX_N:
        del gathers["cluster_"]
    t0 = time.perf_counter()
    for prefix, (_, gather) in gathers.items():
        if prefix != "library_":
            np.testing.assert_array_equal(gather(vals, idx).cpu().numpy(), vals_np[idx_np])
    print(f"build+run OK in {time.perf_counter() - t0:.2f}s")
    print("CORRECT")
    res = {"n": n}
    if dev.type != "cuda":
        print("timings: not measured (cpu)")
        return res
    print(f"device: {torch.cuda.get_device_name(dev)}")
    for prefix, (_, gather) in gathers.items():
        res[prefix + "ms"] = graph_ms(lambda: gather(vals, idx), args.reps)
        t1 = graph_ms(lambda: loop(vals, idx, 1, gather), args.reps)
        t17 = graph_ms(lambda: loop(vals, idx, 17, gather), args.reps)
        res[prefix + "slope_ms"] = (t17 - t1) / 16
    for prefix, (name, _) in gathers.items():
        per, one = res[prefix + "slope_ms"], res[prefix + "ms"]
        print(f"{name} {n} elems: {per * 1e3:.3f} us/iter ({per * 1e6 / n:.4f} ns/elem); "
              f"one launch {one * 1e3:.3f} us")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
