"""The join's duplicate expansion: which row makes each output slot.

Counterpart of ``dj_tpu/ops/pallas_expand.py::expand_values`` and
``expand_ranks``. Each launches its CUDA kernel (``csrc/expand_values.cu``,
``csrc/expand_ranks.cu``) for tensors on the card and takes its plain
version (``expand_values_plain``, ``expand_ranks_plain``) for tensors on
the CPU.

- ``expand_values``: for output slot j, with src = clip(#{csum <= j}, 0,
  S - 1): stag_j = stag[src] and rpos = run_start[src] + j - (csum[src]
  - cnt[src]) in int32. Slots j >= total are unspecified.
- ``expand_ranks``: out[j] = #{csum <= j} for every slot j < n_out (the
  probe tier's src before its clip).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.search import count_leq_arange
from . import cuda_build

launches = 0  # kernel launches made by expand_values
ranks_launches = 0  # kernel launches made by expand_ranks
# The geometry of both kernels (csrc/expand_values.cu,
# csrc/expand_ranks.cu): output slots per block, and the widest window of
# csum positions a block stages in shared memory.
ETILE = 1024
WIN = 8192


def expand_values_plain(
    csum: torch.Tensor, cnt: torch.Tensor, stag: torch.Tensor,
    run_start: torch.Tensor, n_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch formulation: the ``xla_path`` of
    ``_expand_values_jit`` (dj_tpu/ops/pallas_expand.py:912-918)."""
    S = csum.shape[0]
    src = count_leq_arange(csum, n_out).clamp_(0, S - 1).to(torch.int64)
    csum_ex = (csum.to(torch.int64) - cnt.to(torch.int64))[src]
    j = torch.arange(n_out, dtype=torch.int64, device=csum.device)
    rpos = (run_start[src].to(torch.int64) + j - csum_ex).to(torch.int32)
    return stag[src], rpos


def _check_inputs(csum, cnt, stag, run_start, n_out):
    S = csum.shape[0]
    for name, t in (("csum", csum), ("cnt", cnt), ("stag", stag), ("run_start", run_start)):
        if t.dtype != torch.int32 or t.shape != (S,):
            raise ValueError(f"{name} must be int32 of shape ({S},), got {t.dtype} {tuple(t.shape)}")
        if t.device != csum.device:
            raise ValueError(f"{name} is on {t.device}, csum on {csum.device}")
    if S == 0:
        raise ValueError("expand_values needs S >= 1 merged positions")
    if not 0 <= n_out < 2**31 - 1:
        raise ValueError(f"n_out {n_out} outside the int32 slot domain")


def expand_values(
    csum: torch.Tensor, cnt: torch.Tensor, stag: torch.Tensor,
    run_start: torch.Tensor, n_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(stag_j, rpos), each (n_out,) int32; the CUDA kernel on the card,
    the plain version on the CPU."""
    _check_inputs(csum, cnt, stag, run_start, n_out)
    dev = csum.device
    if dev.type == "cpu":
        return expand_values_plain(csum, cnt, stag, run_start, n_out)
    if dev.type != "cuda":
        raise ValueError(f"expand_values: unsupported device {dev}")
    stag_j = torch.empty(n_out, dtype=torch.int32, device=dev)
    rpos = torch.empty(n_out, dtype=torch.int32, device=dev)
    ins = (csum, cnt, stag, run_start)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("expand_values: csum, cnt, stag and run_start must be contiguous")
    if n_out == 0:
        return stag_j, rpos
    fn = cuda_build.load("expand_values").dj_expand_values
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    global launches
    launches += 1
    rc = fn(
        *(t.data_ptr() for t in ins), stag_j.data_ptr(), rpos.data_ptr(),
        csum.shape[0], n_out, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "expand_values")
    return stag_j, rpos


def expand_ranks_plain(csum: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain PyTorch formulation: ``count_leq_arange`` (the ``xla_path``
    of ``_expand_ranks_jit``, dj_tpu/ops/pallas_expand.py:502-503)."""
    return count_leq_arange(csum, n_out)


def expand_ranks(csum: torch.Tensor, n_out: int) -> torch.Tensor:
    """out[j] = #{i : csum[i] <= j} for j in [0, n_out), int32, for a
    sorted non-negative int32 or int64 csum; the CUDA kernel on the
    card, the plain version on the CPU."""
    if csum.dim() != 1 or csum.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"csum must be 1-D int32 or int64, got {csum.dtype} {tuple(csum.shape)}")
    if not 0 <= n_out < 2**31 - 1:
        raise ValueError(f"n_out {n_out} outside the int32 slot domain")
    dev = csum.device
    if dev.type == "cpu":
        return expand_ranks_plain(csum, n_out)
    if dev.type != "cuda":
        raise ValueError(f"expand_ranks: unsupported device {dev}")
    if not csum.is_contiguous():
        raise ValueError("expand_ranks: csum must be contiguous")
    if csum.dtype == torch.int64:
        # Every slot is below 2^31 - 1, so clamping keeps every count
        # (the _csum32 of the JAX package).
        csum = csum.clamp_max(2**31 - 1).to(torch.int32)
    out = torch.empty(n_out, dtype=torch.int32, device=dev)
    if n_out == 0:
        return out
    fn = cuda_build.load("expand_ranks").dj_expand_ranks
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    global ranks_launches
    ranks_launches += 1
    rc = fn(
        csum.data_ptr(), out.data_ptr(), csum.shape[0], n_out,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "expand_ranks")
    return out
