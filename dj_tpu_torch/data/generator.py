"""Dataset generation with exact selectivity semantics, on the device.

Counterpart of ``dj_tpu/data/generator.py:41-255`` (the reference's
generate_build_probe_tables, and its distributed form
``generate_tables_distributed``): build keys drawn from [0, rand_max]
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
from ..parallel.spmd import run_spmd
from ..parallel.topology import Topology


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


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator in
    ``generate_tables_distributed``: (seed, rank) mixed by numpy's
    SeedSequence, so every rank draws an independent stream."""
    return int(np.random.SeedSequence((seed, rank)).generate_state(1, np.uint64)[0])


def _exchange_chunks(comm, bufs: list) -> list:
    """The flat world's equal-chunk all-to-all of [w, c] buffers (row j
    to world rank j, row i of the result from world rank i). On a
    two-level topology it is composed of one exchange per axis, as
    dj_tpu composes its per-axis all_to_alls: chunk (a, b) goes over
    'inter' to domain a, then over 'intra' to rank b of it."""
    if "inter" not in comm.axes:
        return comm.exchange(bufs)
    inter, intra = comm.sub("inter"), comm.sub("intra")
    ni, nj = inter.size, intra.size
    # z[a, b] = the chunk for (my domain, b) from (a, my intra rank)
    z = inter.exchange([b.reshape(ni, nj, -1) for b in bufs])
    # u[b, a] = the chunk for me from (a, b)
    u = intra.exchange([x.transpose(0, 1).contiguous() for x in z])
    return [x.transpose(0, 1).reshape(ni * nj, -1) for x in u]


def generate_tables_distributed(
    topology: Topology,
    build_nrows_per_shard: int,
    probe_nrows_per_shard: int,
    selectivity: float,
    rand_max_per_shard: int,
    uniq_build_tbl_keys: bool,
    seed: int = 0,
    key_dtype: dt.DType = dt.int64,
    payload_dtype: dt.DType = dt.int64,
) -> tuple[Table, torch.Tensor, Table, torch.Tensor]:
    """Generate build/probe tables distributed over the topology's ranks.

    Each rank generates its shard's tables (``generate_build_probe_tables``
    on a generator seeded by ``rank_seed(seed, rank)``) with keys in its
    own range, shifted by ``rank * (rand_max_per_shard + 1)``, and
    payloads shifted by ``rank * nrows_per_shard`` (globally unique row
    ids); then equal chunks go all-to-all, so every shard holds a uniform
    sample (dj_tpu/data/generator.py:162-255). Returns (build,
    build_counts, probe, probe_counts) as sharded tables, every row valid;
    in a process world, this rank's block. A two-level topology gives the
    same shards as the flat one. Keys are unique within a rank
    when ``uniq_build_tbl_keys`` and disjoint across ranks, so the join's
    total is the sum of the ranks' exact expected counts.
    """
    w = topology.world_size
    if build_nrows_per_shard % w or probe_nrows_per_shard % w:
        raise ValueError("per-shard row counts must divide by the world size for equal chunks")

    def body(comm):
        r = comm.world_rank()
        gen = torch.Generator(device=topology.device).manual_seed(rank_seed(seed, r))
        build, probe = generate_build_probe_tables(
            gen, build_nrows_per_shard, probe_nrows_per_shard, selectivity,
            rand_max_per_shard, uniq_build_tbl_keys, key_dtype, payload_dtype,
        )
        key_off = r * (rand_max_per_shard + 1)

        def shifted(tbl, pay_off):
            k, p = tbl.columns
            return [k.data + key_off, p.data + pay_off]

        cols = shifted(build, r * build_nrows_per_shard) + shifted(probe, r * probe_nrows_per_shard)
        del build, probe
        # Equal-chunk all-to-all: chunk j of shard i goes to shard j.
        got = _exchange_chunks(comm, [c.reshape(w, -1) for c in cols])
        bk, bp, pk, pp = (g.reshape(-1) for g in got)

        def table(k, p):
            return Table((Column(k, key_dtype), Column(p, payload_dtype)))

        dev = topology.device
        return (table(bk, bp), torch.full((1,), build_nrows_per_shard, dtype=torch.int32, device=dev),
                table(pk, pp), torch.full((1,), probe_nrows_per_shard, dtype=torch.int32, device=dev))

    return run_spmd(topology, body)
