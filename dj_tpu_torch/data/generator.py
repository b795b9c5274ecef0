"""Dataset generation with exact selectivity semantics, on the device.

Counterpart of ``dj_tpu/data/generator.py:41-159`` (the reference's
generate_build_probe_tables): build keys drawn from [0, rand_max]
(optionally unique), probe keys drawn from the build keys with
probability ``selectivity`` and from their complement otherwise; both
tables carry an iota payload column. Unique build keys and their
complement are the two halves of one random permutation of
[0, rand_max]. Random numbers come from the caller's torch.Generator, so
the data differ from the JAX package's for the same seed; the semantics
and the exact expected match count do not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.table import Column, Table


def host_build_probe_keys(
    n_build: int, n_probe: int, selectivity: float, rng, dtype=np.int64
) -> tuple[np.ndarray, np.ndarray]:
    """Host (numpy) unique-build / provable-miss key generator: build
    keys are n_build unique draws from [0, 2*n_build); probe keys hit
    with probability ``selectivity`` and otherwise draw from
    [2*n_build, 4*n_build), disjoint by construction."""
    build = rng.permutation(np.arange(2 * n_build))[:n_build].astype(dtype)
    hits = rng.random(n_probe) < selectivity
    probe = np.where(
        hits,
        build[rng.integers(0, n_build, n_probe)],
        rng.integers(2 * n_build, 4 * n_build, n_probe),
    ).astype(dtype)
    return build, probe


def generate_build_probe_tables(
    generator: torch.Generator,
    build_nrows: int,
    probe_nrows: int,
    selectivity: float,
    rand_max: int,
    uniq_build_tbl_keys: bool,
    key_dtype: dt.DType = dt.int64,
    payload_dtype: dt.DType = dt.int64,
    return_expected_matches: bool = False,
):
    """Generate (build, probe) tables on ``generator``'s device: a key
    column plus an iota payload column.

    ``return_expected_matches`` (unique build keys only) also returns the
    exact inner-join match count as an int64 0-d tensor: each hit probe
    row matches exactly one build row and each miss none.
    """
    if return_expected_matches and not uniq_build_tbl_keys:
        raise ValueError(
            "exact expected-match counting requires unique build keys"
        )
    if rand_max + 1 <= build_nrows:
        raise ValueError(
            "need rand_max + 1 > build_nrows so that probe misses exist"
        )
    g = generator
    dev = g.device
    if uniq_build_tbl_keys:
        perm = torch.randperm(rand_max + 1, generator=g, device=dev)
        build_keys, complement = perm[:build_nrows], perm[build_nrows:]
    else:
        build_keys = torch.randint(0, rand_max + 1, (build_nrows,), generator=g, device=dev)
        member = torch.zeros(rand_max + 1, dtype=torch.bool, device=dev)
        member[build_keys] = True
        complement = torch.nonzero(~member).flatten()
    hit = torch.rand(probe_nrows, generator=g, device=dev) < selectivity
    hit_idx = torch.randint(0, build_nrows, (probe_nrows,), generator=g, device=dev)
    miss_idx = torch.randint(
        0, max(1, complement.shape[0]), (probe_nrows,), generator=g, device=dev
    )
    probe_keys = torch.where(hit, build_keys[hit_idx], complement[miss_idx])
    del hit_idx, miss_idx, complement

    def table(keys, n):
        return Table(
            (
                Column(keys.to(key_dtype.torch_dtype), key_dtype),
                Column(torch.arange(n, dtype=payload_dtype.torch_dtype, device=dev), payload_dtype),
            )
        )

    build, probe = table(build_keys, build_nrows), table(probe_keys, probe_nrows)
    if return_expected_matches:
        return build, probe, hit.sum(dtype=torch.int64)
    return build, probe
