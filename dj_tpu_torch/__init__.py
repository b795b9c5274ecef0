"""dj_tpu_torch: the distributed inner join on PyTorch and CUDA.

A port of the JAX package ``dj_tpu`` to an NVIDIA H100 (Hopper). Plain
tensor code is PyTorch; each TPU kernel on the ported paths has a
hand-written CUDA counterpart in ``csrc/`` (join_scans, expand_values,
merge_sorted_u64, expand_ranks), built with nvcc at first use. Entry
points run on the current CUDA device unless given CPU tensors or a CPU
topology, where each kernel's plain PyTorch version runs instead.

Ported so far: the unprepared inner join on int keys (generate -> shard
-> distributed_inner_join), and the prepared build side
(prepare_join_side once, then distributed_inner_join with the
PreparedSide per query, under the sort, merge or probe tier), over a
world of one rank or of several ranks on one device, run as threads of
this process: ``make_topology(["cuda:0"] * 4)`` makes a 4-rank world.
"""

from .core import dtypes
from .core.table import Column, Table, concatenate, from_arrays
from .data.generator import generate_build_probe_tables
from .ops.join import inner_join
from .ops.partition import hash_partition
from .parallel.api import shard_table, unshard_table
from .parallel.dist_join import (
    JoinConfig,
    PreparedSide,
    distributed_inner_join,
    prepare_join_side,
)
from .parallel.topology import Topology, make_topology
from .resilience.errors import PreparedPlanMismatch

__all__ = [
    "Column",
    "JoinConfig",
    "PreparedPlanMismatch",
    "PreparedSide",
    "Table",
    "Topology",
    "concatenate",
    "distributed_inner_join",
    "dtypes",
    "from_arrays",
    "generate_build_probe_tables",
    "hash_partition",
    "inner_join",
    "make_topology",
    "prepare_join_side",
    "shard_table",
    "unshard_table",
]
