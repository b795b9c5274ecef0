"""The yardstick of the kernel rooflines: the card's peak and each
kernel's least bytes.

A kernel's roofline share is the least time the card could take for the
bytes its call needs, over the time the profiler gave the kernel. The
bytes count each input byte read once and each output byte written once,
and only what these inputs need: the S merged positions of the join's
two sides (its valid rows, not the capacities the program allocates)
and the join's matches (not the output capacity). Both kernels are
bound by bytes: they do a few integer operations a byte.

- ``join_scans`` reads one 8-byte sorted word a position and writes four
  int32 (stag, run_start, cnt, csum): 8 in, 16 out a position.
- ``expand_values`` reads four int32 a position (csum, cnt, stag,
  run_start) and writes two int32 a match (the build row's stag, the
  probe row's position): 16 a position in, 8 a match out.

These are the formulas under ``PERF.md``'s kernel table, with the
output counted by matches.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (H100 80GB HBM3): 3.35 TB/s of HBM bandwidth, the
# data sheet's figure at its 700 W power limit.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
DEFAULT_PEAK = 3.35e12

KERNELS = {
    # name in the metric: (substring of the CUDA symbol, bytes(positions, matches))
    "join_scans": ("join_scans_kernel", lambda s, m: 8 * s + 16 * s),
    "expand_values": ("expand_values_kernel", lambda s, m: 16 * s + 8 * m),
}


def peak_bytes_per_s(device_kind: str) -> float:
    return PEAK_BYTES_PER_S.get(device_kind, DEFAULT_PEAK)


def kernel_seconds(summaries: list, symbol: str) -> tuple:
    """(seconds, launches) of the device operations whose name holds
    ``symbol``, summed over the ranks' stretches."""
    sec = n = 0
    for s in summaries:
        for name, (t, k) in s["ops"].items():
            if symbol in name:
                sec += t
                n += k
    return sec, n


def share_pct(kernel: str, ctx: dict):
    """``kernel``'s roofline share in percent over the traced stretch, or
    None when the stretch holds none of its launches."""
    symbol, nbytes = KERNELS[kernel]
    summaries = ctx.get("profiles") or []
    sec, launches = kernel_seconds(summaries, symbol)
    work = ctx.get("work")
    if not launches or not sec or not work or not ctx.get("stretch_calls"):
        return None
    need = ctx["stretch_calls"] * nbytes(work["positions"], work["matches"])
    return 100.0 * need / peak_bytes_per_s(ctx.get("device_kind", "")) / sec
