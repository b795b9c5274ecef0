"""dj_tpu_torch: the distributed inner join on PyTorch and CUDA.

A port of the JAX package ``dj_tpu`` to an NVIDIA H100 (Hopper). Plain
tensor code is PyTorch; the two TPU kernels on the main path have
hand-written CUDA counterparts (``csrc/join_scans.cu``,
``csrc/expand_values.cu``), built with nvcc at first use. Entry points
run on the current CUDA device unless given CPU tensors or a CPU
topology, where each kernel's plain PyTorch version runs instead.

This slice covers the unprepared inner join on a single-int key over a
one-rank world: generate -> shard -> distributed_inner_join.
"""

from .core import dtypes
from .core.table import Column, Table, concatenate, from_arrays
from .data.generator import generate_build_probe_tables
from .ops.join import inner_join
from .ops.partition import hash_partition
from .parallel.api import shard_table, unshard_table
from .parallel.dist_join import JoinConfig, distributed_inner_join
from .parallel.topology import Topology, make_topology

__all__ = [
    "Column",
    "JoinConfig",
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
    "shard_table",
    "unshard_table",
]
