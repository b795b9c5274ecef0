"""ops/strings.py's string_gather wrapper on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py's phase 8h holds it
to the plain version there); here the wrapper's input checks, its CPU
route, the tile it mirrors from the kernel source, and a rehearsal of
phase 8h with the card stubbed. ``StringColumn.take``'s parity with
dj_tpu is in tests/test_torch_strings.py.
"""

import importlib.util
import pathlib
import re
import time
import types

import pytest
import torch

import dj_tpu_torch as tj
from dj_tpu_torch.core.table import sizes_to_offsets, take_fill
from dj_tpu_torch.ops import cuda_build, strings

REPO = pathlib.Path(__file__).resolve().parents[1]


def _inputs():
    """(new_offsets, starts, chars, cap) of 8 rows gathered from 6,
    duplicated and out of range among them: 25 bytes."""
    sizes = torch.tensor([3, 0, 5, 1, 7, 2], dtype=torch.int32)
    offsets = sizes_to_offsets(sizes)
    idx = torch.tensor([4, 4, 0, 9, 2, 5, 1, 3])
    chars = torch.arange(int(offsets[-1]) + 3, dtype=torch.int32).to(torch.uint8)
    new_offsets = sizes_to_offsets(take_fill(sizes, idx))
    return new_offsets, take_fill(offsets, idx), chars, 40


def _bad(case):
    no, st, ch, cap = _inputs()
    return {
        "offsets_int64": (no.to(torch.int64), st, ch, cap),
        "starts_int64": (no, st.to(torch.int64), ch, cap),
        "chars_int8": (no, st, ch.to(torch.int8), cap),
        "offsets_one_short": (no[:-1], st, ch, cap),
        "starts_2d": (no, st.reshape(2, -1), ch, cap),
        "chars_2d": (no, st, ch[:8].reshape(2, 4), cap),
        "meta_device": (no.to("meta"), st.to("meta"), ch.to("meta"), cap),
        "devices_differ": (no.to("meta"), st, ch, cap),
        "chars_not_contiguous": (no, st, torch.stack([ch, ch], 1).reshape(-1)[::2], cap),
        "starts_not_contiguous": (no, torch.stack([st, st], 1)[:, 0], ch, cap),
        "cap_negative": (no, st, ch, -1),
        "cap_past_int32": (no, st, ch, 2**31),
    }[case]


@pytest.mark.parametrize("case", [
    "offsets_int64", "starts_int64", "chars_int8", "offsets_one_short", "starts_2d", "chars_2d",
    "meta_device", "devices_differ", "chars_not_contiguous", "starts_not_contiguous",
    "cap_negative", "cap_past_int32"])
def test_rejects_bad_inputs(case):
    with pytest.raises(ValueError, match="string_gather"):
        strings.string_gather(*_bad(case))


@pytest.mark.parametrize("cap", [0, 5, 25, 40])
def test_cpu_takes_the_plain_version_and_counts_no_launch(cap):
    """Below, at (25 bytes) and above the need, and cap 0: the plain
    version's bytes, the row bytes where they fit and zeros past them,
    and no launch counted."""
    no, st, ch, _ = _inputs()
    before = strings.launches
    got = strings.string_gather(no, st, ch, cap)
    assert strings.launches == before
    assert torch.equal(got, strings.string_gather_plain(no, st, ch, cap))
    want = b"".join(bytes(ch[s:s + n].tolist()) for s, n in zip(st.tolist(), no.diff().tolist()))
    assert len(want) == 25 and bytes(got.tolist()) == (want + bytes(cap))[:cap]
    col = tj.StringColumn(sizes_to_offsets(torch.tensor([3, 0, 5], dtype=torch.int32)), ch)
    col.take(torch.tensor([2, 0]), cap)
    assert strings.launches == before


def test_zero_rows_give_zero_chars():
    got = strings.string_gather(torch.zeros(1, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
                                torch.ones(9, dtype=torch.uint8), 13)
    assert got.dtype == torch.uint8 and got.tolist() == [0] * 13


def test_tile_and_window_match_the_kernel_source():
    """The wrapper's TILE is the kernel's NT * VB and its WIN the rows a
    block stages, which chip_smoke's ``gather_windows`` reads."""
    text = (cuda_build.CSRC / "string_gather.cu").read_text()
    const = {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
             for k in ("NT", "VB", "WIN")}
    assert strings.TILE == const["NT"] * const["VB"]
    assert strings.WIN == const["WIN"]


def test_chip_smoke_string_gather_phase_rehearses_on_cpu(monkeypatch, capsys):
    """chip_smoke's phase 8h on CPU tensors: the card's calls stubbed,
    string_gather made to count its plain calls; every edge case and the
    timed gather on 4000 rows of TPC-H's priorities, every check as on
    the card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    class Event:
        def __init__(self, **kw):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    for name, fn in (("synchronize", lambda *a, **k: None), ("Event", Event),
                     ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    real = strings.string_gather

    def counted(*a, **k):
        strings.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(strings, "string_gather", counted)
    dj = types.SimpleNamespace(**{k: getattr(tj, k) for k in tj.__all__})
    words = [b"1-URGENT", b"2-HIGH", b"3-MEDIUM", b"4-NOT SPECIFIED", b"5-LOW"]
    gen = torch.Generator().manual_seed(0)
    priorities = tj.from_strings([words[i] for i in torch.randint(0, 5, (1000,), generator=gen)],
                                 device="cpu")
    t = cs.check_string_gather(dj, torch.device("cpu"), priorities, 4000, "cpu")
    assert t["rows"] == 4000 and t["cap"] == int(priorities.chars.shape[0] * cs.CHAR_FIT)
    # Each case's take on the "card" and its plain side here, the
    # checked gather, and the kernel and take timed (a warm-up and 5 each).
    assert t["launches"] == 2 * len(cs.string_gather_cases(dj)) + 1 + 6 + 6
    out = capsys.readouterr().out
    assert out.count('"kernel": "string_gather"') == len(cs.string_gather_cases(dj))
    assert '"blocks_over_win": 1' in out and "[string_gather]" in out
