"""Warmups: pay one-time set-up costs before timing or serving.

Counterpart of ``dj_tpu/parallel/warmup.py``: ``warmup_all_to_all`` (the
reference's warmup_all_to_all, all_to_all_comm.cpp:191-233),
``warmup_prepared_join`` and ``warmup_compression`` (the reference's
warmup_nvcomp, compression.cpp:170-196). The port compiles no module per
shape, so what a warmup pays here is the transport's set-up (NCCL builds
a communicator at its first collective on a group), the kernels' builds
and loads, and the allocator's first blocks. Each warmup records one
``warmup`` event and counts ``dj_warmup_total{kind}``, as dj_tpu's do.
``warmup_join_index`` warms each resident entry of a join-index cache
(``cache.JoinIndexCache``) the same way.
"""

from __future__ import annotations

import torch

from .. import obs
from ..compress import cascaded as cz
from ..resilience import errors as resil
from .spmd import run_spmd
from .topology import Topology


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warmup_all_to_all(topology: Topology, nbytes: int = 10_000_000) -> None:
    """A dummy all-to-all of about ``nbytes`` in all over each of the
    topology's axes (the world on a flat topology; 'inter' and 'intra'
    on a two-level one), through the communicator of the topology's kind
    of world, then a synchronize."""
    w = topology.world_size
    per_shard = max(w * w, nbytes // 8) // w
    for axis in topology.axis_names:
        def run(comm, axis=axis):
            c = comm if axis == topology.main_group().axis_name else comm.sub(axis)
            bucket = max(1, per_shard // c.size)
            buckets = torch.zeros((c.size, bucket), dtype=torch.int64, device=topology.device)
            return c.all_to_all(buckets).reshape(-1)

        run_spmd(topology, run)
        obs.record("warmup", kind="all_to_all", axis=axis, nbytes=nbytes)
        obs.inc("dj_warmup_total", kind="all_to_all")
    _sync(topology.device)


def warmup_prepared_join(topology: Topology, prepared, left_example, left_counts, left_on,
                         config=None) -> None:
    """One throwaway query of ``left_example`` against ``prepared``, then
    a synchronize: the first live query then finds the kernels built and
    loaded and the transport set up. The example's data does not matter,
    its shapes and dtypes do. A lease-like object (one with
    ``.prepared`` and no ``.batches``, as dj_tpu's join-index lease) is
    unwrapped first.

    The query and its synchronize run under the degradation ladder
    (``resilience.degrade_guard``, tiers "merge" and "wire"), as
    dj_tpu's: a tier that fails here pins its baseline, with the
    ``degrade`` event, and serving starts on the baseline. A kernel that
    does not build or launch, or a device fault the synchronize reports
    (the query's launches are asynchronous), fails the warmup instead:
    no baseline stands in for a broken kernel."""
    from .dist_join import distributed_inner_join

    if hasattr(prepared, "prepared") and not hasattr(prepared, "batches"):
        prepared = prepared.prepared

    def attempt():
        distributed_inner_join(topology, left_example, left_counts, prepared, None, left_on,
                               None, config)
        _sync(topology.device)

    resil.degrade_guard("warmup_prepared_join", attempt, tiers=("merge", "wire"),
                        config=config if config is not None else prepared.config,
                        topology=topology)
    obs.record("warmup", kind="prepared_join")
    obs.inc("dj_warmup_total", kind="prepared_join")


def warmup_join_index(topology: Topology, cache, left_example, left_counts, left_on,
                      config=None) -> int:
    """Warm every resident entry of the join-index ``cache`` before
    traffic arrives (the serving bookend of ``cache.warm_restart``, which
    re-prepares the inventory): one :func:`warmup_prepared_join` an
    entry, under its own pin (``cache.lease``), so no eviction races the
    walk. An entry that fails (key dtypes or sizing the example does not
    fit, a heal out of budget, a transport hiccup) is skipped with a
    ``warmup`` event and the walk goes on. A kernel that does not build or
    launch, or a device fault, fails the walk instead, as it fails
    :func:`warmup_prepared_join`: no skip hides a broken kernel. Returns
    the number of entries warmed."""
    warmed = 0
    for key in cache.keys():
        try:
            lease = cache.lease(key)
        except KeyError:
            continue  # evicted between keys() and lease()
        with lease:
            try:
                warmup_prepared_join(topology, lease.prepared, left_example, left_counts,
                                     left_on, config)
                warmed += 1
            except Exception as e:  # noqa: BLE001 - the walk survives an entry
                if resil._kernel_failure(e):
                    raise
                obs.record("warmup", kind="join_index_skip", key=key[:200],
                           error=type(e).__name__)
    obs.record("warmup", kind="join_index", warmed=warmed)
    obs.inc("dj_warmup_total", kind="join_index")
    return warmed


def warmup_compression(itemsize: int = 8, bucket_rows: int = 4096, device=None) -> None:
    """One codec round trip of two dummy [bucket_rows] buckets of
    ``itemsize``-byte ints under the full cascade (RLE, delta, bitpack)
    on ``device`` (default the current CUDA device), which also builds
    the expand_ranks kernel of the RLE decode if nothing has built it
    yet. Raises if the round trip does not give back its input."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    opts = cz.CascadedOptions(num_rles=1, num_deltas=1, use_bp=True)
    cap = cz.compressed_capacity_words(bucket_rows * itemsize, 1.0)
    dtype = cz._INT_OF_SIZE[itemsize]
    x = torch.arange(2 * bucket_rows, device=dev).to(dtype).reshape(2, bucket_rows)
    counts = torch.full((2,), bucket_rows, dtype=torch.int32, device=dev)
    words, _, overflow = cz.compress_buckets(x, itemsize, opts, cap, counts)
    back = cz.decompress_buckets(words, itemsize, opts, bucket_rows, dtype)
    _sync(dev)
    if bool(overflow.any()) or not torch.equal(back, x):
        raise RuntimeError("warmup_compression: the codec's round trip changed its input")
    obs.record("warmup", kind="compression", itemsize=itemsize, bucket_rows=bucket_rows)
    obs.inc("dj_warmup_total", kind="compression")
