"""A traced stretch of the window: the device's timeline from torch.profiler.

``Stretch`` profiles a few steady calls (host and device activity), and
``summarize`` reduces the events to what the per-layer readers and the
result line need: the stretch's length, the seconds in which the device
ran any operation (kernels, copies and fills, overlaps counted once),
each device operation's seconds and launches, the longest idle gaps
named by what the host was doing, and the busy intervals themselves.
It also gives the seconds in which the device ran an operation other
than a collective's (``COLLECTIVE``: an NCCL kernel spins on the card
while it waits for a peer, so it is busy to the profiler while the
rank waits). Nothing is written to disk. torch is imported where it is
used, so that a parent that only joins its ranks' summaries never
loads it.
"""

from __future__ import annotations

import time
from typing import Optional

MARK = "joinbench.stretch"
TOP = 10
NAME_CHARS = 96
COLLECTIVE = "nccl"  # a device operation whose name starts so is a collective's kernel


class Stretch:
    """``with Stretch(device) as s:`` profiles the block; ``s.finish()``,
    called once the window has closed (reading the events holds the
    interpreter for a while), sets ``s.summary`` (None on a device the
    profiler cannot trace).
    ``s.mono0`` and ``s.mark_us0`` tie the host's monotonic clock to
    the trace's: a monotonic time t is trace time
    ``(t - mono0) * 1e6 + mark_us0``."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self.summary: Optional[dict] = None
        self.mono0 = 0.0

    def __enter__(self) -> "Stretch":
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._rf = record_function(MARK)
        self.mono0 = time.monotonic()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._rf.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        if exc[0] is not None or self.device.type != "cuda":
            self._prof = None

    def finish(self) -> Optional[dict]:
        if self._prof is not None:
            self.summary = summarize(self._prof.events())
            self._prof = None
        return self.summary

    @property
    def mark_us0(self) -> float:
        return self.summary["mark_us"][0] if self.summary else 0.0


def _merge(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_label(cpu: list, t: float) -> str:
    """The innermost host event running at trace time ``t``."""
    best = None
    for name, a, b in cpu:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "host: no traced op"


def summarize(events) -> dict:
    """{window_s, busy_s, busy_ex_collective_s, ops: {name: [s, launches]},
    gaps: [[label, s]], busy_us: [[a, b]], mark_us: [a, b]} of the
    profiled stretch."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    mark = next(e for e in events if e.name == MARK and e.device_type != cuda)
    w0, w1 = mark.time_range.start, mark.time_range.end
    host_names = {e.name for e in events if e.device_type != cuda}
    dev, compute, cpu, ops = [], [], [], {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # A record_function range's device-side copy is no operation.
            if getattr(e, "is_user_annotation", False) or e.name in host_names:
                continue
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                if not e.name.lower().startswith(COLLECTIVE):
                    compute.append((a, b))
                name = e.name[:NAME_CHARS]
                s, n = ops.get(name, (0.0, 0))
                ops[name] = (s + (b - a) / 1e6, n + 1)
        elif e.name != MARK:
            cpu.append((e.name[:NAME_CHARS], a, b))
    busy = _merge(dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "busy_ex_collective_s": sum(b - a for a, b in _merge(compute)) / 1e6,
        "ops": {k: list(v) for k, v in top_ops},
        "gaps": [[_host_label(cpu, t), d / 1e6] for d, t in gaps],
        "busy_us": busy,
        "mark_us": [w0, w1],
    }


def covered_s(busy_us: list, spans_us: list) -> tuple:
    """(seconds of ``spans_us`` the device was busy, seconds of
    ``spans_us``), each span list merged first."""
    spans = _merge(spans_us)
    total = sum(b - a for a, b in spans)
    both, i = 0.0, 0
    for a, b in spans:
        while i < len(busy_us) and busy_us[i][1] <= a:
            i += 1
        j = i
        while j < len(busy_us) and busy_us[j][0] < b:
            both += min(b, busy_us[j][1]) - max(a, busy_us[j][0])
            j += 1
    return both / 1e6, total / 1e6


def breakdown(summaries: list) -> dict:
    """The result line's ``breakdown`` over the ranks' stretches: each
    device operation's seconds averaged over the chips, and the longest
    idle gaps of any rank (named with the rank where there are several)."""
    ops: dict = {}
    gaps = []
    for r, s in enumerate(summaries):
        for name, (sec, _) in s["ops"].items():
            ops[name] = ops.get(name, 0.0) + sec / len(summaries)
        prefix = f"rank {r}: " if len(summaries) > 1 else ""
        gaps += [[prefix + label, sec] for label, sec in s["gaps"]]
    return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": sorted(gaps, key=lambda kv: -kv[1])[:TOP]}
