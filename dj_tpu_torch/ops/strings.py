"""The char gather of ``StringColumn.take``: the output bytes of the
gathered rows.

No TPU kernel stands behind it: the JAX package's ``StringColumn.take``
(dj_tpu/core/table.py:77-108) is plain jnp. ``string_gather`` launches
the CUDA kernel ``csrc/string_gather.cu`` for tensors on the card and
takes the plain version, ``string_gather_plain`` (a search of the new
offsets for each output byte, then gathers), for tensors on the CPU.
For n rows and each output byte j < cap: ``chars[starts[r] + j -
new_offsets[r]]`` (0 where that lies outside chars) for j below
``new_offsets[n]``, r the row that holds j, and 0 from there to cap.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.search import interval_of_arange
from ..core.table import take_fill
from . import cuda_build

launches = 0  # kernel launches made by string_gather
TILE = 4096  # output bytes a block of csrc/string_gather.cu writes (NT * VB)
WIN = 4096  # rows a block stages in shared memory; a wider window reads global memory


def _check_inputs(new_offsets: torch.Tensor, starts: torch.Tensor, chars: torch.Tensor,
                  cap: int) -> None:
    """Raise unless new_offsets is int32 (n + 1,), starts int32 (n,) and
    chars uint8 1-D, all contiguous on one device, and the cap output
    positions fit int32."""
    n = starts.shape[0] if starts.dim() == 1 else -1
    for name, t, dtype, shape in (("new_offsets", new_offsets, torch.int32, (n + 1,)),
                                  ("starts", starts, torch.int32, (n,)),
                                  ("chars", chars, torch.uint8, (chars.numel(),))):
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"string_gather: {name} must be {dtype} of shape {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != starts.device:
            raise ValueError(f"string_gather: {name} is on {t.device}, starts on {starts.device}")
        if not t.is_contiguous():
            raise ValueError(f"string_gather: {name} must be contiguous")
    if starts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"string_gather: unsupported device {starts.device}")
    if not 0 <= cap < 2**31:
        raise ValueError(f"string_gather: cap {cap} outside the int32 positions")


def string_gather_plain(new_offsets: torch.Tensor, starts: torch.Tensor, chars: torch.Tensor,
                        cap: int) -> torch.Tensor:
    """Plain PyTorch formulation: each output byte finds its row by
    ``interval_of_arange`` over the new offsets and reads the source
    byte at the row's start plus its place in the row (the JAX
    package's ``StringColumn.take``)."""
    if starts.shape[0] == 0:
        return torch.zeros(cap, dtype=torch.uint8, device=chars.device)
    pos = torch.arange(cap, dtype=torch.int32, device=chars.device)
    row = interval_of_arange(new_offsets, cap, starts.shape[0])
    src = starts[row]
    src += pos
    src -= new_offsets[row]
    del row
    beyond = pos >= new_offsets[-1]
    del pos
    return take_fill(chars, src).masked_fill_(beyond, 0)


def string_gather(new_offsets: torch.Tensor, starts: torch.Tensor, chars: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """The cap output chars (uint8) of n gathered rows; the CUDA kernel
    on the card, the plain version on the CPU."""
    _check_inputs(new_offsets, starts, chars, cap)
    if starts.device.type == "cpu":
        return string_gather_plain(new_offsets, starts, chars, cap)
    # A fresh allocation: 16-byte aligned, as the kernel's word stores need.
    out = torch.empty(cap, dtype=torch.uint8, device=starts.device)
    if cap:
        global launches
        launches += 1
        fn = cuda_build.load("string_gather").dj_string_gather
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(new_offsets.data_ptr(), starts.data_ptr(), chars.data_ptr(), out.data_ptr(),
                starts.shape[0], chars.shape[0], cap,
                torch.cuda.current_stream(out.device).cuda_stream)
        cuda_build.check(rc, "string_gather")
    return out
