"""The join's duplicate expansion: which row makes each output slot.

Counterpart of ``dj_tpu/ops/pallas_expand.py``'s six expansion kernels.
Each entry point launches its CUDA kernel (``csrc/<name>.cu``) for
tensors on the card and takes its plain version (``<name>_plain``, the
``xla_path`` of the JAX function) for tensors on the CPU. With src =
#{csum <= j} and src' = clip(src, 0, S - 1), for output slot j:

- ``expand_values`` (vmeta): stag_j = stag[src'] and rpos =
  run_start[src'] + j - (csum[src'] - cnt[src']) in int32.
- ``expand_ranks`` (ranks, and the probe tier): src itself.
- ``expand_gather`` (fused): (src, stag[src'], run_start[src']).
- ``expand_join`` (join): (stag[src'], stag[clip(run_start[src'] + t, 0,
  S - 1)]) with t = j - csum[src' - 1] (0 for src' = 0).
- ``expand_carry`` (vcarry): (rpos, slot_k[src'] for each payload slot).
- ``expand_vfull`` (vfull): (slot_k[src'] ..., key[rpos'], slot_k[rpos']
  ...) with rpos' = clip(rpos, 0, S - 1).

csum is the int32 inclusive cumsum of cnt; slots j >= total are
unspecified in every output. The payload slots and the key are u64 bit
patterns in int64 tensors; the TPU kernels carry each as two int32
planes because Mosaic has no 64-bit types.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.search import count_leq_arange
from . import cuda_build

launches = 0  # kernel launches made by expand_values
ranks_launches = 0  # kernel launches made by expand_ranks
gather_launches = 0  # kernel launches made by expand_gather
join_launches = 0  # kernel launches made by expand_join
carry_launches = 0  # kernel launches made by expand_carry
vfull_launches = 0  # kernel launches made by expand_vfull
# The geometry of the five expansion kernels on csrc/expand_window.cuh
# (every one but expand_ranks): output slots per block, and the widest
# window of csum positions a block stages in shared memory.
ETILE = 1024
WIN = 8192
# Payload slots expand_carry and expand_vfull take (the join's vcarry
# gate, n_payload <= 3).
MAX_SLOTS = 3
# Merged items (csum rows plus output slots) per CTA of expand_ranks'
# merge-path kernel (NV of csrc/expand_ranks.cu).
RANKS_NV = 3328

_P, _LL = ctypes.c_void_p, ctypes.c_longlong


def _check_inputs(what: str, n_out: int, int32s, int64s=()) -> None:
    """Raise unless each (name, tensor) of ``int32s`` is int32 and of
    ``int64s`` int64, all of shape (S,) on the first one's device, with
    S >= 1 and n_out in the int32 slot domain."""
    first = int32s[0][1]
    S = first.shape[0]
    for dtype, named in ((torch.int32, int32s), (torch.int64, int64s)):
        for name, t in named:
            if t.dtype != dtype or t.shape != (S,):
                raise ValueError(f"{what}: {name} must be {dtype} of shape ({S},), got {t.dtype} {tuple(t.shape)}")
            if t.device != first.device:
                raise ValueError(f"{what}: {name} is on {t.device}, {int32s[0][0]} on {first.device}")
    if S == 0:
        raise ValueError(f"{what} needs S >= 1 merged positions")
    if not 0 <= n_out < 2**31 - 1:
        raise ValueError(f"{what}: n_out {n_out} outside the int32 slot domain")


def _on_card(what: str, tensors) -> bool:
    """False for CPU tensors (the plain version runs), True for
    contiguous CUDA tensors (the kernel runs); raises otherwise."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: every input must be contiguous")
    return True


def _run(name: str, argtypes: list, *args) -> None:
    """Launch ``dj_<name>`` of ``csrc/<name>.cu`` on the current stream;
    tensors pass as their device pointers. Raises on a launch error."""
    fn = getattr(cuda_build.load(name), f"dj_{name}")
    fn.argtypes = argtypes + [_P]
    fn.restype = ctypes.c_int
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    rc = fn(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, name)


def _pointer_array(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers (one null entry when
    there are none); the caller keeps it alive across the call."""
    return (_P * max(1, len(tensors)))(*(t.data_ptr() for t in tensors))


def _src(csum: torch.Tensor, n_out: int) -> torch.Tensor:
    """src' = clip(#{csum <= j}, 0, S - 1) per slot, int64."""
    return count_leq_arange(csum, n_out).clamp_(0, csum.shape[0] - 1).to(torch.int64)


def _rpos(csum, cnt, run_start, src: torch.Tensor) -> torch.Tensor:
    """run_start[src] + j - (csum[src] - cnt[src]) in int32 (wrapping)."""
    j = torch.arange(src.shape[0], dtype=torch.int64, device=src.device)
    csum_ex = csum[src].to(torch.int64) - cnt[src].to(torch.int64)
    return (run_start[src].to(torch.int64) + j - csum_ex).to(torch.int32)


def expand_values_plain(
    csum: torch.Tensor, cnt: torch.Tensor, stag: torch.Tensor,
    run_start: torch.Tensor, n_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch formulation: the ``xla_path`` of
    ``_expand_values_jit`` (dj_tpu/ops/pallas_expand.py:912-918)."""
    src = _src(csum, n_out)
    return stag[src], _rpos(csum, cnt, run_start, src)


def expand_values(
    csum: torch.Tensor, cnt: torch.Tensor, stag: torch.Tensor,
    run_start: torch.Tensor, n_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(stag_j, rpos), each (n_out,) int32; the CUDA kernel on the card,
    the plain version on the CPU."""
    ins = (csum, cnt, stag, run_start)
    _check_inputs("expand_values", n_out, tuple(zip(("csum", "cnt", "stag", "run_start"), ins)))
    if not _on_card("expand_values", ins):
        return expand_values_plain(csum, cnt, stag, run_start, n_out)
    stag_j, rpos = (torch.empty(n_out, dtype=torch.int32, device=csum.device) for _ in range(2))
    if n_out:
        global launches
        launches += 1
        _run("expand_values", [_P] * 6 + [_LL, _LL], *ins, stag_j, rpos, csum.shape[0], n_out)
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
    if not _on_card("expand_ranks", (csum,)):
        return expand_ranks_plain(csum, n_out)
    if csum.dtype == torch.int64:
        # Every slot is below 2^31 - 1, so clamping keeps every count
        # (the _csum32 of the JAX package).
        csum = csum.clamp_max(2**31 - 1).to(torch.int32)
    S = csum.shape[0]
    out = torch.empty(n_out, dtype=torch.int32, device=csum.device)
    if n_out:
        # One merge-path split per CTA boundary (the kernel's scratch).
        splits = torch.empty(-(-(S + n_out) // RANKS_NV) + 1, dtype=torch.int64,
                             device=csum.device)
        global ranks_launches
        ranks_launches += 1
        _run("expand_ranks", [_P] * 3 + [_LL, _LL], csum, out, splits, S, n_out)
    return out


def expand_gather_plain(
    csum: torch.Tensor, stag: torch.Tensor, run_start: torch.Tensor, n_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch formulation: the ``xla_path`` of
    ``_expand_gather_jit`` (dj_tpu/ops/pallas_expand.py:570-577)."""
    src = count_leq_arange(csum, n_out)
    s = src.clamp(0, csum.shape[0] - 1).to(torch.int64)
    return src, stag[s], run_start[s]


def expand_gather(
    csum: torch.Tensor, stag: torch.Tensor, run_start: torch.Tensor, n_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(src, stag[src'], run_start[src']), each (n_out,) int32, src
    unclipped; the CUDA kernel on the card, the plain version on the
    CPU."""
    ins = (csum, stag, run_start)
    _check_inputs("expand_gather", n_out, tuple(zip(("csum", "stag", "run_start"), ins)))
    if not _on_card("expand_gather", ins):
        return expand_gather_plain(csum, stag, run_start, n_out)
    outs = tuple(torch.empty(n_out, dtype=torch.int32, device=csum.device) for _ in range(3))
    if n_out:
        global gather_launches
        gather_launches += 1
        _run("expand_gather", [_P] * 6 + [_LL, _LL], *ins, *outs, csum.shape[0], n_out)
    return outs


def expand_join_plain(
    csum: torch.Tensor, stag: torch.Tensor, run_start: torch.Tensor, n_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch formulation: the ``xla_path`` of
    ``_expand_join_jit`` (dj_tpu/ops/pallas_expand.py:1452-1468)."""
    S = csum.shape[0]
    src = _src(csum, n_out)
    j = torch.arange(n_out, dtype=torch.int64, device=csum.device)
    csum_ex = torch.where(src > 0, csum[(src - 1).clamp_min(0)].to(torch.int64), 0)
    rp = (run_start[src].to(torch.int64) + j - csum_ex).to(torch.int32)
    return stag[src], stag[rp.to(torch.int64).clamp_(0, S - 1)]


def expand_join(
    csum: torch.Tensor, stag: torch.Tensor, run_start: torch.Tensor, n_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(stag_j, rtag), each (n_out,) int32: the query's and the matched
    ref's merged tags; the CUDA kernel on the card, the plain version on
    the CPU. Unlike the TPU kernel it needs no ``max_run``: the CUDA
    kernel reads a ref at any distance below its query."""
    ins = (csum, stag, run_start)
    _check_inputs("expand_join", n_out, tuple(zip(("csum", "stag", "run_start"), ins)))
    if not _on_card("expand_join", ins):
        return expand_join_plain(csum, stag, run_start, n_out)
    outs = tuple(torch.empty(n_out, dtype=torch.int32, device=csum.device) for _ in range(2))
    if n_out:
        global join_launches
        join_launches += 1
        _run("expand_join", [_P] * 5 + [_LL, _LL], *ins, *outs, csum.shape[0], n_out)
    return outs


def _check_slots(what: str, n_out: int, int32s, slots, key=None) -> None:
    if len(slots) > MAX_SLOTS:
        raise ValueError(f"{what}: {len(slots)} payload slots, at most {MAX_SLOTS}")
    int64s = tuple((f"slots[{k}]", s) for k, s in enumerate(slots))
    _check_inputs(what, n_out, int32s, int64s + ((("key", key),) if key is not None else ()))


def expand_carry_plain(
    csum: torch.Tensor, cnt: torch.Tensor, run_start: torch.Tensor, slots, n_out: int,
) -> tuple:
    """Plain PyTorch formulation: the ``xla_path`` of
    ``_expand_carry_jit`` (dj_tpu/ops/pallas_expand.py:994-1002)."""
    src = _src(csum, n_out)
    return (_rpos(csum, cnt, run_start, src),) + tuple(s[src] for s in slots)


def expand_carry(
    csum: torch.Tensor, cnt: torch.Tensor, run_start: torch.Tensor, slots, n_out: int,
) -> tuple:
    """(rpos, slot_0[src'], ...): rpos (n_out,) int32, each payload slot
    (n_out,) int64 (u64 bits); at most MAX_SLOTS slots. The CUDA kernel
    on the card, the plain version on the CPU."""
    slots = tuple(slots)
    ins = (csum, cnt, run_start)
    _check_slots("expand_carry", n_out, tuple(zip(("csum", "cnt", "run_start"), ins)), slots)
    if not _on_card("expand_carry", ins + slots):
        return expand_carry_plain(csum, cnt, run_start, slots, n_out)
    dev = csum.device
    rpos = torch.empty(n_out, dtype=torch.int32, device=dev)
    outs = tuple(torch.empty(n_out, dtype=torch.int64, device=dev) for _ in slots)
    if n_out:
        slot_ptrs, out_ptrs = _pointer_array(slots), _pointer_array(outs)
        global carry_launches
        carry_launches += 1
        _run("expand_carry", [_P] * 4 + [ctypes.c_int, _P, _P, _LL, _LL], *ins,
             ctypes.addressof(slot_ptrs), len(slots), rpos, ctypes.addressof(out_ptrs),
             csum.shape[0], n_out)
    return (rpos,) + outs


def expand_vfull_plain(
    csum: torch.Tensor, cnt: torch.Tensor, run_start: torch.Tensor, slots,
    key: torch.Tensor, n_out: int,
) -> tuple:
    """Plain PyTorch formulation: the ``xla_path`` of
    ``_expand_vfull_jit`` (dj_tpu/ops/pallas_expand.py:1359-1375)."""
    src = _src(csum, n_out)
    rpos = _rpos(csum, cnt, run_start, src).to(torch.int64).clamp_(0, csum.shape[0] - 1)
    return tuple(s[src] for s in slots) + (key[rpos],) + tuple(s[rpos] for s in slots)


def expand_vfull(
    csum: torch.Tensor, cnt: torch.Tensor, run_start: torch.Tensor, slots,
    key: torch.Tensor, n_out: int,
) -> tuple:
    """(slot_0[src'], ..., key[rpos'], slot_0[rpos'], ...), each (n_out,)
    int64 (u64 bits): the left payloads, the key and the right payloads
    of every output slot; at most MAX_SLOTS slots. The CUDA kernel on the
    card, the plain version on the CPU. Unlike the TPU kernel it needs no
    ``max_run`` and no margin."""
    slots = tuple(slots)
    ins = (csum, cnt, run_start)
    _check_slots("expand_vfull", n_out, tuple(zip(("csum", "cnt", "run_start"), ins)), slots, key)
    if not _on_card("expand_vfull", ins + slots + (key,)):
        return expand_vfull_plain(csum, cnt, run_start, slots, key, n_out)
    dev = csum.device
    louts, routs = (tuple(torch.empty(n_out, dtype=torch.int64, device=dev) for _ in slots)
                    for _ in range(2))
    key_j = torch.empty(n_out, dtype=torch.int64, device=dev)
    if n_out:
        ptrs = [_pointer_array(t) for t in (slots, louts, routs)]
        global vfull_launches
        vfull_launches += 1
        _run("expand_vfull", [_P] * 4 + [ctypes.c_int] + [_P] * 4 + [_LL, _LL], *ins,
             ctypes.addressof(ptrs[0]), len(slots), key, ctypes.addressof(ptrs[1]), key_j,
             ctypes.addressof(ptrs[2]), csum.shape[0], n_out)
    return louts + (key_j,) + routs
