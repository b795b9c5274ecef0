"""Warmups: pay one-time set-up costs before timing or serving.

Counterpart of ``dj_tpu/parallel/warmup.py``: ``warmup_all_to_all`` (the
reference's warmup_all_to_all, all_to_all_comm.cpp:191-233),
``warmup_prepared_join`` and ``warmup_compression`` (the reference's
warmup_nvcomp, compression.cpp:170-196). The port compiles no module per
shape, so what a warmup pays here is the transport's set-up (NCCL builds
a communicator at its first collective on a group), the kernels' builds
and loads, and the allocator's first blocks. Each warmup records one
``warmup`` event and counts ``dj_warmup_total{kind}``, as dj_tpu's do.
``warmup_join_index`` walks the join-index cache and comes with it
(ROADMAP item 10d).
"""

from __future__ import annotations

import torch

from .. import obs
from ..compress import cascaded as cz
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
    unwrapped first. dj_tpu's degradation guard around the query comes
    with the fault ladder (ROADMAP item 10b)."""
    from .dist_join import distributed_inner_join

    if hasattr(prepared, "prepared") and not hasattr(prepared, "batches"):
        prepared = prepared.prepared
    distributed_inner_join(topology, left_example, left_counts, prepared, None, left_on, None,
                           config)
    _sync(topology.device)
    obs.record("warmup", kind="prepared_join")
    obs.inc("dj_warmup_total", kind="prepared_join")


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
