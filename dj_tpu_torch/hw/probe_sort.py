"""Probe: how fast is a sort of tiles held in fast memory on the card?

Counterpart of ``scripts/hw/probe_sort.py``. That probe asks whether a
tile sort inside a TPU kernel is cheap enough to build the join's sort
from; here the tile sits in an SM's registers and shared memory, the
short strides of its bitonic network in registers and warp shuffles and
the long ones in shared memory. ``tile_sort``
launches the CUDA kernel ``csrc/tile_sort.cu`` for a tensor on the card
and takes the plain version, ``tile_sort_plain`` (a bitonic network in
PyTorch), for a tensor on the CPU.

The words are uint32, as in the JAX probe. PyTorch has no uint32
kernel for ``minimum`` or ``maximum`` (on the CPU or the card) nor for
``sort`` on the card, so the plain version and the library yardsticks
work on the int32 view with the top bit flipped, which maps unsigned
order onto signed order (as ``ops/merge.py`` does for u64 words). The
yardsticks sort that view made before the timing starts: the same work
on 32-bit keys.

Run on the card:  python -m dj_tpu_torch.hw.probe_sort
On the CPU (checks only, no timing):  ... --device cpu --tile 256 --nt 4
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time

import numpy as np
import torch

from ..ops import cuda_build

TILE = 32_768  # words per tile (the JAX probe's)
NT = 64  # tiles per call (the JAX probe's)
MAX_TILE = 32_768  # the largest tile the kernel's shared memory holds
INT32_MIN = -(2**31)

launches = 0  # kernel launches made by tile_sort


def _check(x: torch.Tensor, tile: int) -> int:
    """The number of tiles; raises unless x is a 1-D uint32 tensor of NT
    whole tiles of ``tile`` words, 1 <= tile <= MAX_TILE."""
    if x.dtype != torch.uint32 or x.dim() != 1:
        raise ValueError(f"tile_sort: x must be 1-D uint32, got {x.dtype} {tuple(x.shape)}")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile_sort: tile {tile} outside [1, {MAX_TILE}]")
    if x.numel() == 0 or x.numel() % tile:
        raise ValueError(f"tile_sort: {x.numel()} words are not NT >= 1 tiles of {tile}")
    return x.numel() // tile


def tile_sort_plain(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Plain PyTorch formulation: a bitonic network over each tile padded
    to a power of two P with 0xFFFFFFFF, one vectorised compare-exchange
    per stage on the (NT, P) view. It is the network with direction bits;
    the kernel's compares mirrors instead and pads to at least 1024
    words, and both give the sorted tile."""
    nt = _check(x, tile)
    p = 1 << (tile - 1).bit_length()
    # Flipped words: 0xFFFFFFFF becomes INT32_MAX, the largest.
    v = torch.full((nt, p), 2**31 - 1, dtype=torch.int32, device=x.device)
    v[:, :tile] = x.view(torch.int32).view(nt, tile) ^ INT32_MIN
    k = 2
    while k <= p:
        j = k // 2
        while j:
            pairs = v.view(nt, p // (2 * j), 2, j)
            a, b = pairs[:, :, 0], pairs[:, :, 1]
            # Pairs in a 2j-block whose first position has bit k set sort
            # descending, the rest ascending.
            first = torch.arange(0, p, 2 * j, device=x.device)
            descending = ((first & k) != 0).view(1, -1, 1)
            lo, hi = torch.minimum(a, b), torch.maximum(a, b)
            a.copy_(torch.where(descending, hi, lo))
            b.copy_(torch.where(descending, lo, hi))
            j //= 2
        k *= 2
    return (v[:, :tile] ^ INT32_MIN).reshape(-1).view(torch.uint32)


def tile_sort(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Each ``tile``-word tile of x sorted ascending as unsigned 32-bit
    words, a new (NT * tile,) uint32 tensor; the CUDA kernel on the card,
    the plain version on the CPU."""
    nt = _check(x, tile)
    dev = x.device
    if dev.type == "cpu":
        return tile_sort_plain(x, tile)
    if dev.type != "cuda":
        raise ValueError(f"tile_sort: unsupported device {dev}")
    if not x.is_contiguous():
        raise ValueError("tile_sort: x must be contiguous")
    out = torch.empty_like(x)
    fn = cuda_build.load("tile_sort").dj_tile_sort
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    global launches
    launches += 1
    rc = fn(x.data_ptr(), out.data_ptr(), nt, tile, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "tile_sort")
    return out


def to_numpy_u32(x: torch.Tensor) -> np.ndarray:
    """A uint32 tensor's words as a numpy uint32 array (through the int32
    view: the card's PyTorch copies uint32 only in part)."""
    return x.view(torch.int32).cpu().numpy().view(np.uint32)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    """Check tile_sort against numpy and, on the card, time it beside the
    library's sorts; prints CORRECT and one line per timing, and returns
    {"n", "tile", "nt", "ms", "library_ms", "flat_ms"} (times in ms, on
    the card only)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tile", type=int, default=TILE)
    ap.add_argument("--nt", type=int, default=NT)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_sort: no CUDA device (pass --device cpu to check on the CPU)")
    n = args.nt * args.tile
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randint(INT32_MIN, 2**31, (n,), dtype=torch.int32, generator=gen,
                      device=dev).view(torch.uint32)
    t0 = time.perf_counter()
    out = tile_sort(x, args.tile)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"tile-sort build+run {time.perf_counter() - t0:.2f}s")
    want = np.sort(to_numpy_u32(x).reshape(args.nt, args.tile), axis=1)
    np.testing.assert_array_equal(to_numpy_u32(out).reshape(args.nt, args.tile), want)
    print("CORRECT")
    res = {"n": n, "tile": args.tile, "nt": args.nt}
    if dev.type != "cuda":
        print("timings: not measured (cpu)")
        return res
    print(f"device: {torch.cuda.get_device_name(dev)}")
    res["ms"] = cuda_ms(lambda: tile_sort(x, args.tile), args.reps)
    flipped = x.view(torch.int32) ^ INT32_MIN
    res["library_ms"] = cuda_ms(lambda: torch.sort(flipped.view(args.nt, args.tile), dim=1), args.reps)
    res["flat_ms"] = cuda_ms(lambda: torch.sort(flipped), args.reps)
    for name, key in (("tile_sort kernel", "ms"), ("torch.sort(dim=1)", "library_ms"),
                      ("torch.sort flat", "flat_ms")):
        print(f"{name}: {res[key]:.4f} ms ({res[key] * 1e6 / n:.4f} ns/elem)")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
