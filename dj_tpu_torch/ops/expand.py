"""The join's duplicate expansion: (stag_j, rpos) for each output slot.

Counterpart of ``dj_tpu/ops/pallas_expand.py::expand_values``.
``expand_values`` launches the CUDA kernel ``csrc/expand_values.cu`` for
tensors on the card and takes the plain version, ``expand_values_plain``,
for tensors on the CPU. For output slot j, with src = clip(#{csum <= j},
0, S - 1): stag_j = stag[src] and rpos = run_start[src] + j - (csum[src]
- cnt[src]) in int32. Slots j >= total are unspecified.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.search import count_leq_arange
from . import cuda_build

launches = 0  # kernel launches made by expand_values
# The kernel's geometry (csrc/expand_values.cu): output slots per block,
# and the widest window of merged positions it stages in shared memory.
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
