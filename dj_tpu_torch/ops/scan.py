"""The join's match-range scans over the sorted packed words.

Counterpart of ``dj_tpu/ops/pallas_scan.py``. ``join_scans`` launches
the CUDA kernel ``csrc/join_scans.cu`` for a tensor on the card and
takes the plain version, ``join_scans_plain``, for a tensor on the CPU.

The packed words are u64 bit patterns held in an int64 tensor (PyTorch
has little uint64 coverage): ascending in unsigned order,
``(key - min) << tag_bits | tag`` with refs tagged 0..R-1 and queries
R..R+L-1, padding all-ones (-1 as int64). Outputs are int32 (stag,
run_start, cnt, csum); csum wraps past 2^31 exactly as the JAX kernel's
does, and the exact int64 total is ``cnt.sum()``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

launches = 0  # kernel launches made by join_scans


def _count(c, device) -> torch.Tensor:
    return torch.as_tensor(c, device=device).reshape(()).to(torch.int32)


def join_scans_plain(
    sp: torch.Tensor, l_count, r_count, tag_bits: int, L: int, R: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch formulation: the decode of ``_pack_sort_core`` and
    ``_match_scans_xla`` (dj_tpu/ops/join.py:535-562, 780-825)."""
    S = L + R
    dev = sp.device
    raw = (sp & ((1 << tag_bits) - 1)).to(torch.int32)
    stag = torch.where(
        raw < R, raw + L, torch.where(raw < S, raw - R, torch.full_like(raw, S))
    )
    # Equal keys <=> equal top bits: the arithmetic shift of the int64
    # view keeps that equivalence.
    key = sp >> tag_bits
    boundary = torch.ones(S, dtype=torch.bool, device=dev)
    boundary[1:] = key[1:] != key[:-1]
    is_q = (stag < L).to(torch.int32)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    q_before = torch.cumsum(is_q, 0, dtype=torch.int32) - is_q
    ref_before = pos - q_before
    neg = torch.full_like(pos, -1)
    run_lo = torch.cummax(torch.where(boundary, ref_before, neg), 0).values
    run_start = torch.cummax(torch.where(boundary, pos, neg), 0).values
    hi = torch.minimum(ref_before, _count(r_count, dev))
    cnt = torch.clamp_min(hi - run_lo, 0)
    cnt = torch.where(stag < _count(l_count, dev), cnt, 0).to(torch.int32)
    # int64 cumsum cast back to int32: the int32 wraparound of the JAX
    # kernel, computed without relying on signed overflow.
    csum = torch.cumsum(cnt, 0, dtype=torch.int64).to(torch.int32)
    return stag, run_start, cnt, csum


def join_scans(
    sp: torch.Tensor, l_count, r_count, tag_bits: int, L: int, R: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Match-range scans; the CUDA kernel on the card, the plain version
    on the CPU."""
    S = L + R
    if sp.dtype != torch.int64 or sp.shape != (S,):
        raise ValueError(f"sp must be int64 of shape ({S},), got {sp.dtype} {tuple(sp.shape)}")
    if not 0 < tag_bits < 32 or (1 << tag_bits) - 1 < S:
        raise ValueError(f"tag_bits {tag_bits} cannot tag S = {S}")
    if sp.device.type == "cpu":
        return join_scans_plain(sp, l_count, r_count, tag_bits, L, R)
    if sp.device.type != "cuda":
        raise ValueError(f"join_scans: unsupported device {sp.device}")
    if not sp.is_contiguous() or sp.data_ptr() % 16:
        raise ValueError("join_scans: sp must be contiguous and 16-byte aligned")
    lib = cuda_build.load("join_scans")
    fn = lib.dj_join_scans
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.dj_join_scans_scratch_ints.argtypes = [ctypes.c_longlong]
    lib.dj_join_scans_scratch_ints.restype = ctypes.c_longlong
    dev = sp.device
    counts = torch.stack([_count(l_count, dev), _count(r_count, dev)])
    outs = [torch.empty(S, dtype=torch.int32, device=dev) for _ in range(4)]
    scratch = torch.empty(
        max(1, lib.dj_join_scans_scratch_ints(S)), dtype=torch.int32, device=dev
    )
    global launches
    launches += 1
    rc = fn(
        sp.data_ptr(), counts.data_ptr(), *(o.data_ptr() for o in outs),
        scratch.data_ptr(), S, L, R, tag_bits,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "join_scans")
    return tuple(outs)
