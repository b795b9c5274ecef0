"""dj_tpu_torch: the distributed inner join on PyTorch and CUDA.

A port of the JAX package ``dj_tpu`` to an NVIDIA H100 (Hopper). Plain
tensor code is PyTorch; each TPU kernel of the JAX package has a
hand-written CUDA counterpart in ``csrc/``, built with nvcc at first
use: the join's join_scans, expand_values, expand_ranks,
merge_sorted_u64, expand_carry, expand_gather, expand_join and
expand_vfull, the string columns' string_gather (which replaces plain
jnp, not a TPU kernel), and the hardware probes' tile_sort and gathers
(take_gather, cluster_gather). Entry points run on the current CUDA
device unless given CPU tensors or a CPU topology, where each kernel's
plain PyTorch version runs instead.

Ported so far: the unprepared inner join (generate -> shard
-> distributed_inner_join), and the prepared build side
(prepare_join_side once, then distributed_inner_join with the
PreparedSide per query, under the sort, merge or probe tier), over a
world of one rank, of several ranks on one device run as threads of this
process (``make_topology(["cuda:0"] * 4)`` makes a 4-rank world), or of
one rank per process: a process world. Every process of a process world
calls ``init_distributed()`` (arguments, ``DJT_COORDINATOR_ADDRESS`` /
``DJT_NUM_PROCESSES`` / ``DJT_PROCESS_ID``, or torchrun's variables;
NCCL on the card, gloo for CPU ranks), then ``make_topology()``, which
gives one rank per process on ``cuda:LOCAL_RANK``; every process passes
the same global tables to ``shard_table`` and gets back its own block,
and each entry point returns this rank's block with every rank's flags.
The collectives' backend is ``JoinConfig.communicator_cls``:
``XlaCommunicator`` (the default), ``BufferedCommunicator`` or
``RingCommunicator``, as in dj_tpu.

Any of these worlds may be two-level: ``make_topology(...,
intra_size=i)`` factors the ranks into ('inter', 'intra') groups
(``largest_intra_size`` gives the reference's choice of i), and every
join path then pre-shuffles both sides over 'inter'
(``JoinConfig.pre_shuffle_out_factor``, the ``pre_shuffle_overflow``
flag) before its main stage over 'intra'. ``shuffle_on`` hash-shuffles
a sharded table over the world or over one axis, and ``shuffle_on_auto``
heals its overflows.

The join takes every fixed-width key dj_tpu takes: signed and unsigned
ints of any width (uint64 included), floats, two dtypes per key pair and
several key columns, packed into one sort word where a range allows and
sorted unpacked otherwise, with ``carry_payloads`` and every expansion
mode. String columns (``StringColumn``: int32 offsets and uint8 chars;
``from_strings`` / ``to_strings`` build and read them) ride the
partition, the two-buffer exchange and the join as payloads, with
``JoinConfig.char_out_factor`` sizing the output's chars and the
``char_overflow`` flag when it is too small; a string key joins through
a 64-bit surrogate hash whose matches are verified byte for byte
(``surrogate_collision``).

The two-level pre-shuffle, ``shuffle_on`` and ``shuffle_on_auto`` can
send their buckets through the cascaded wire codec (``compress``: RLE,
zigzag delta and FoR bitpack into a static ``wire_factor`` of the raw
bytes, its RLE decode on the expand_ranks kernel):
``generate_auto_select_compression_options`` samples each column and
picks its cascade, ``broadcast_compression_options`` gives every process
rank 0's choice, and ``JoinConfig.left_compression`` /
``right_compression`` or ``shuffle_on(compression=...)`` take it;
``warmup_compression`` runs the codec once. The prepared side carries
string payloads on either side, and ``append_to_prepared`` merges
appended build rows into it (``combine_prepared_source`` gives its
source with them). ``distributed_inner_join_auto`` answers any input: it heals
overflowing capacities, a wrong declared key range and a prepared side
the probe keys fall outside of, remembering the healed factors in the
capacity ledger (``resilience``; ``DJT_LEDGER=<path>`` keeps it), and
raises ``CapacityExhausted`` when its ``HealBudget`` runs out. A call
that fails with an optional tier active (the merge and probe tiers, the
probe tier's expansion, the adaptive plans, the broadcast and salted
prepared sides, the compressed wire) pins that tier's baseline for the
process and runs again (``resilience.degrade_guard``;
``resilience.pinned_tiers()`` says what is pinned); a kernel that does
not build or launch fails the call instead (``KernelError``), and
``DJT_FAULT=site@call=N`` makes a named site fail on cue
(``resilience.faults``).

The skew-adaptive plans (``plan_adapt``): under ``DJT_PLAN_ADAPT=1``
the unprepared join decides once per signature between the broadcast
plan (the build side all-gathered to every rank, no all-to-all), the
salted plan (a heavy destination's rows scattered over salt peers) and
the shuffle plan; ``prepare_join_side`` builds on the tier
``DJT_PREPARED_TIER`` names (shuffle, broadcast, salted or auto).

The composition layers: ``distributed_join_pipeline`` (and its healing
``_auto``) chains joins (``JoinStage``) with each intermediate on the
device, planned by ``plan_pipeline``: a stage whose sides are already
co-partitioned joins with no collective, a small right side is
broadcast, a PreparedSide is queried. ``distributed_inner_join_coalesced``
(against a PreparedSide) and ``distributed_inner_join_coalesced_unprepared``
serve K same-shaped queries with one exchange epoch a batch;
``DJT_SHAPE_BUCKET=1`` (``shape_bucket``) pads near-miss shapes to one
bucket so they group. ``warmup_all_to_all`` and ``warmup_prepared_join``
pay the set-up costs before timing.

A server keeps its prepared sides in a ``JoinIndexCache`` (``cache``;
``IndexConfig``, ``DJT_INDEX_HBM_BUDGET``, ``DJT_INDEX_MANIFEST``): one
resident side a (tenant, name, dataset, plan signature), refcounted
leases, LRU eviction of unpinned sides under a byte budget, appends
through the cache, a JSONL warm restart, and ``warmup_join_index`` over
the inventory. ``DJT_FLEET_DIR`` coordinates several such workers through
files (``fleet``: prepare leases, budget rows, a SIGTERM drain). In front
of it all, ``QueryScheduler`` (``serve``; ``ServeConfig``,
``DJT_SERVE_HBM_BUDGET`` and its family) admits each query against a byte-model forecast,
queues it with a deadline, walks a pressure ladder over the degradation
tiers and coalesces same-signature queries into one dispatch.

Observability (``obs``; ``DJT_OBS=1`` or ``DJT_OBS_LOG=<path>``): a
metrics registry (``obs.metrics_text()``), a flight recorder of every
heal, ledger hit, plan and prepared tier, codec choice, shape-bucket
pad, pipeline stage and warmup (``obs.events()``, ``obs.drain()``),
per-query timelines (``obs.query_ctx``, ``obs.query_trace``,
``obs.export_trace``) and roofline phases timed with CUDA events on the
card (``obs.roofline``). ``PhaseTimer``, ``annotate`` and ``profile``
are the reference's timing helpers (a ``torch.profiler`` trace shows the
join's phases as ranges). ``knobs`` lists every ``DJT_*`` variable the
package reads.
"""

from . import knobs  # noqa: F401 - the DJT_* registry
from . import obs  # noqa: F401 - the metrics/flight-recorder namespace
from .compress import (
    CascadedOptions,
    ColumnCompressionOptions,
    broadcast_compression_options,
    generate_auto_select_compression_options,
    generate_none_compression_options,
)
from .core import dtypes
from .core.table import (
    Column,
    StringColumn,
    Table,
    concatenate,
    from_arrays,
    from_strings,
    to_strings,
)
from .data.generator import generate_build_probe_tables, generate_tables_distributed
from .ops.hashing import (
    DEFAULT_HASH_SEED,
    HASH_IDENTITY,
    HASH_MURMUR3,
    hash_columns,
    murmur3_32,
)
from .ops.join import inner_join
from .ops.partition import hash_partition
from .parallel.api import (
    collect_tables,
    distribute_table,
    shard_table,
    shard_table_pieces,
    unshard_table,
)
from .parallel.bootstrap import (
    init_distributed,
    is_distributed_initialized,
    process_count,
    process_index,
)
from .parallel.communicator import (
    BufferedCommunicator,
    Communicator,
    RingCommunicator,
    XlaCommunicator,
)
from .parallel.dist_join import (
    JoinConfig,
    PreparedSide,
    append_to_prepared,
    combine_prepared_source,
    distributed_inner_join,
    distributed_inner_join_auto,
    distributed_inner_join_coalesced,
    distributed_inner_join_coalesced_unprepared,
    prepare_join_side,
)
from .parallel.pipeline import (
    JoinStage,
    distributed_join_pipeline,
    distributed_join_pipeline_auto,
    plan_pipeline,
)
from .parallel.shuffle import shuffle_on, shuffle_on_auto
from .parallel import plan_adapt  # noqa: F401 - the planner's namespace, as in dj_tpu
from .parallel import shape_bucket  # noqa: F401 - the shape grid's namespace, as in dj_tpu
from .parallel.topology import CommunicationGroup, Topology, largest_intra_size, make_topology
from .parallel.warmup import (
    warmup_all_to_all,
    warmup_compression,
    warmup_join_index,
    warmup_prepared_join,
)
from . import cache  # noqa: F401 - the join-index cache namespace, as in dj_tpu
from .cache import IndexConfig, JoinIndexCache
from . import serve  # noqa: F401 - the scheduler's namespace, as in dj_tpu
from .serve import QueryScheduler, ServeConfig
from .utils.timing import PhaseTimer, annotate, profile
from . import resilience
from .resilience import (
    AdmissionRejected,
    BackendError,
    CapacityExhausted,
    ContractViolation,
    DeadlineExceeded,
    DJError,
    FaultInjected,
    HealBudget,
    PlanMismatch,
    PreparedPlanMismatch,
    QueueFull,
    deadline_scope,
)

__all__ = [
    "AdmissionRejected",
    "BackendError",
    "BufferedCommunicator",
    "CapacityExhausted",
    "CascadedOptions",
    "Column",
    "ColumnCompressionOptions",
    "CommunicationGroup",
    "Communicator",
    "ContractViolation",
    "DEFAULT_HASH_SEED",
    "DJError",
    "DeadlineExceeded",
    "FaultInjected",
    "HASH_IDENTITY",
    "HASH_MURMUR3",
    "HealBudget",
    "IndexConfig",
    "JoinConfig",
    "JoinIndexCache",
    "JoinStage",
    "PhaseTimer",
    "PlanMismatch",
    "PreparedPlanMismatch",
    "PreparedSide",
    "QueryScheduler",
    "QueueFull",
    "RingCommunicator",
    "ServeConfig",
    "StringColumn",
    "Table",
    "Topology",
    "XlaCommunicator",
    "annotate",
    "append_to_prepared",
    "broadcast_compression_options",
    "collect_tables",
    "combine_prepared_source",
    "concatenate",
    "deadline_scope",
    "distribute_table",
    "distributed_inner_join",
    "distributed_inner_join_auto",
    "distributed_inner_join_coalesced",
    "distributed_inner_join_coalesced_unprepared",
    "distributed_join_pipeline",
    "distributed_join_pipeline_auto",
    "dtypes",
    "from_arrays",
    "from_strings",
    "generate_auto_select_compression_options",
    "generate_build_probe_tables",
    "generate_none_compression_options",
    "generate_tables_distributed",
    "hash_columns",
    "hash_partition",
    "init_distributed",
    "inner_join",
    "is_distributed_initialized",
    "largest_intra_size",
    "make_topology",
    "murmur3_32",
    "plan_pipeline",
    "prepare_join_side",
    "process_count",
    "process_index",
    "profile",
    "resilience",
    "shard_table",
    "shard_table_pieces",
    "shuffle_on",
    "shuffle_on_auto",
    "to_strings",
    "unshard_table",
    "warmup_all_to_all",
    "warmup_compression",
    "warmup_join_index",
    "warmup_prepared_join",
]
