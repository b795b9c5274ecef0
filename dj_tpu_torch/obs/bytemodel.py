"""The byte model: modeled HBM traffic and residency, in one place.

Counterpart of ``dj_tpu/obs/bytemodel.py``. Two models live here:

1. :func:`hbm_model_bytes`, the least HBM traffic of one join as
   configured (``pipeline_model_bytes`` sums it over a chain's stages),
   and :func:`prepared_side_bytes`, what a prepared side pins. Admission
   (ROADMAP item 10e) and the autotuner's price
   (``dist_join.price_plan_candidate``) read them.
2. :func:`buffer_bytes` and :func:`replicated_table_bytes`: the bytes of
   the buffers an exchange or a broadcast moves, in which the collective
   counters (``dj_collective_bytes_total``) and the broadcast fit count.

``hbm_model_bytes`` computes dj_tpu's function: given the same numbers
and the same plan it returns the same integer. Several of its terms
price dj_tpu's TPU lowering, not the port's kernels: "hist" is a
scatter-add that XLA:TPU lowers as a hidden sort, the unpacked scans are
XLA's chain of separate passes, and a bucketed sort that the port does
not have. They are kept on purpose: the model is a forecast contract,
read by admission as dj_tpu's reads it, not a roofline of the H100. A
model of the card's own kernels is a later benchmark's work.

The model reads dj_tpu's plan terms (``scans``, ``expand``, ``packed``,
``carry``, ``sort``). :func:`model_plan` derives them from the port's
``ops.join.JoinPlan(expand, packed, carry)`` with dj_tpu's gates
(``effective_plan``, dj_tpu/ops/join.py:1055-1123): the scans are the
kernel's (``join_scans``, "pallas") on the packed path without carry and
"xla" otherwise; the port's expansion modes map to dj_tpu's names as
README's ``DJT_JOIN_EXPAND`` table maps them; the sort is always
"monolithic", the port's only one. The merge tiers map likewise: the
port's "sort", "merge" and "probe" are dj_tpu's "xla", "pallas" and
"probe".

Stdlib only at import; the sizing helper and the probe tier's expansion
knob are imported inside the function.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

# The port's DJT_JOIN_EXPAND modes under dj_tpu's DJ_JOIN_EXPAND names.
EXPAND_NAMES = {
    "vmeta": "pallas-vmeta", "ranks": "pallas", "hist": "hist", "fused": "pallas-fused",
    "join": "pallas-join", "vcarry": "pallas-vcarry", "vfull": "pallas-vfull",
}
# The port's DJT_JOIN_MERGE tiers under dj_tpu's DJ_JOIN_MERGE names.
MERGE_NAMES = {"sort": "xla", "merge": "pallas", "probe": "probe"}
# dj_tpu's DJ_JOIN_SORT_BUCKETS and DJ_JOIN_SORT_SLACK defaults: the port
# has no bucketed sort, so they price only a plan that names one.
_SORT_BUCKETS = 32
_SORT_SLACK = 2.0


class ModelPlan(NamedTuple):
    """A plan in dj_tpu's terms (its ``ops.join.JoinPlan``)."""

    scans: str
    expand: str
    packed: bool
    carry: bool
    sort: str = "monolithic"


def model_plan(plan) -> ModelPlan:
    """dj_tpu's plan terms of the port's ``JoinPlan`` (module docstring).
    A plan that already has them (a :class:`ModelPlan`, dj_tpu's own)
    passes through."""
    if hasattr(plan, "scans"):
        return ModelPlan(plan.scans, plan.expand, plan.packed, plan.carry,
                         getattr(plan, "sort", "monolithic"))
    scans = "pallas" if plan.packed and not plan.carry else "xla"
    return ModelPlan(scans, EXPAND_NAMES[plan.expand], bool(plan.packed), bool(plan.carry))


def buffer_bytes(shape, itemsize: int) -> int:
    """Bytes of one buffer of ``shape`` and ``itemsize``-byte elements."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * int(itemsize)


def _column_bytes(c) -> int:
    """A column's buffer bytes: a string column's int32 offsets and
    uint8 chars (duck-typed on ``.chars``), else its data."""
    if hasattr(c, "chars"):
        return buffer_bytes(c.offsets.shape, 4) + buffer_bytes(c.chars.shape, 1)
    return buffer_bytes(c.data.shape, c.data.element_size())


def prepared_side_bytes(prepared) -> int:
    """What one PreparedSide pins: its sorted packed words, sorted
    payload tables and counts, summed over its odf batches, global over
    the world. Duck-typed over ``prepared.batches`` ((words, payload
    table, counts) a batch), so the model imports no parallel code."""
    total = 0
    for words, ptab, pcnt in prepared.batches:
        total += buffer_bytes(words.shape, words.element_size())
        total += sum(_column_bytes(c) for c in ptab.columns)
        total += buffer_bytes(pcnt.shape, pcnt.element_size())
    return total


def replicated_table_bytes(table) -> int:
    """The buffer bytes of every column of ``table``: what one rank holds
    once the broadcast tier has gathered the table, when ``table`` is
    the global one. The broadcast fit prices it against
    ``DJT_BROADCAST_BYTES``."""
    return sum(_column_bytes(c) for c in table.columns)


def pipeline_model_bytes(stage_kwargs) -> int:
    """A chain of joins priced as one number: the sum of its stages'
    :func:`hbm_model_bytes` (``stage_kwargs``, one keyword dict a stage;
    a local stage prices as ``plan_tier="local"``, a broadcast one as
    "broadcast"). The intermediates stay on the device, so HBM traffic
    adds up over the stages."""
    return sum(int(hbm_model_bytes(**kw)) for kw in stage_kwargs)


def hbm_model_bytes(
    rows: int,
    odf: int,
    config,
    matches: int,
    plan,
    prepared: bool = False,
    merge_impl: str = "sort",
    *,
    plan_tier: str = "shuffle",
    right_rows: Optional[int] = None,
    world: int = 1,
    salt_replicas: int = 1,
) -> int:
    """Least HBM traffic of one join of ``rows`` a side (dj_tpu's
    ``hbm_model_bytes``, dj_tpu/obs/bytemodel.py:88-372, term for term).

    ``plan`` is the port's ``JoinPlan`` (or dj_tpu's terms,
    :func:`model_plan`); ``merge_impl`` the port's merge tier of a
    prepared query. ``plan_tier`` prices the skew-adaptive plans:
    "local" (the pipeline's co-partitioned join: no partition, no
    collective, one join of the two shards), "broadcast" (no partition
    or exchange: the all-gather of ``world`` x ``right_rows`` build rows
    and one join at that size), "salted" (the ``salt_replicas - 1``
    build copies' bucketize and their share of each batch's sort and
    scans). ``right_rows`` (build rows a shard) defaults to ``rows``.
    ``prepared`` prices one prepared query: the build side's partition
    and bucketize are gone (paid at prepare time, not here), and the
    merge tier sets the sort term; a broadcast-prepared query is one
    batch against the replicated run, a salted-prepared one sees the
    replicas in its run."""
    from ..ops.join import resolve_probe_expand
    from ..parallel.dist_join import BatchSizing, batch_sizing

    plan = model_plan(plan)
    merge_impl = MERGE_NAMES.get(merge_impl, merge_impl)
    bs = batch_sizing(config, 1, rows, rows)
    side = 16 * rows  # one table, 2 int64 columns
    total = 0
    rr = right_rows if right_rows is not None else rows
    scan_bytes = 24 if plan.scans.startswith("pallas") else 56
    if not prepared and plan_tier in ("local", "broadcast"):
        # local: one join of the two shards; broadcast: the all-gather and
        # compact (r+w) of the replicated build side, then one join of the
        # local shard against it.
        other = rr if plan_tier == "local" else max(1, world) * rr
        s_j = rows + other
        out_cap = max(1, int(config.join_out_factor * max(rows, other)))
        if plan_tier == "broadcast":
            total += 2 * 16 * other
        sort_width = 8 if plan.packed else 12
        total += math.ceil(math.log2(max(s_j, 2))) * 2 * sort_width * s_j
        total += scan_bytes * s_j
        total += 8 * s_j + 16 * out_cap  # expansion meta chain
        total += matches * (4 + 16 + 8 + 24)
        return total
    if prepared and plan_tier == "broadcast":
        # One partition-free batch: the left shard against the resident
        # replicated run, gathered at prepare time.
        rep = max(1, world) * rr
        out_b = max(1, int(config.join_out_factor * max(rows, rep)))
        bs = BatchSizing(1, rows, rep, rows, rep, out_b)
        odf = 1
    elif prepared and plan_tier == "salted" and salt_replicas > 1:
        # Each batch's resident run carries the replicas' windows.
        bs = bs._replace(br=salt_replicas * bs.br)
    if bs.m > 1:
        sides = 1 if prepared else 2
        total += sides * 2 * side  # hash partition reorder (read + write)
        total += sides * 2 * side  # bucketize + compact self-copy (r+w)
    s = bs.bl + bs.br
    if prepared and merge_impl.startswith("probe"):
        # Probe tier: no sort and no S-sized scans. A batch: the anchored
        # pack, two log2(br)-round binary searches, the bl-scale count
        # chain, the src source and the expansion, then the per-match
        # output gathers.
        rounds = max(1, math.ceil(math.log2(max(bs.br, 2))))
        if resolve_probe_expand() == "hist":
            # dj_tpu's histogram: a hidden out_cap-scale scatter sort on
            # the TPU, plus the 16 B/slot chain.
            expand_bytes = (math.ceil(math.log2(max(bs.out_cap, 2))) * 2 * 4 * bs.out_cap
                            + 16 * bs.out_cap)
        else:
            r_bl = max(1, math.ceil(math.log2(max(bs.bl, 2))))
            expand_bytes = (4 * r_bl + 12) * bs.out_cap
        total += odf * (16 * bs.bl + 2 * rounds * 8 * bs.bl + 16 * bs.bl + 4 * bs.bl
                        + expand_bytes)
        total += matches * (16 + 8 + 24)
        return total
    expand = plan.expand
    vfull = expand.startswith("pallas-vfull")
    vcarry = expand.startswith("pallas-vcarry") or vfull
    # Merged sort: ~log2(S) passes, r+w a pass; packed 8 B, unpacked 12
    # B; carry and vcarry add one 8 B payload slot.
    sort_width = (8 if plan.packed else 12) + (8 if (vcarry or plan.carry) else 0)
    if prepared and merge_impl.startswith("pallas"):
        # The left-only sort at bl depth and one merge pass over both runs.
        total += odf * (math.ceil(math.log2(max(bs.bl, 2))) * 2 * 8 * bs.bl + 2 * 8 * s)
    elif plan.sort == "bucketed":
        # dj_tpu's two-pass bucketed sort (grouping pass, the [K, C]
        # bucket pass, the extract and compact copies).
        k = 1 << max(1, (_SORT_BUCKETS - 1).bit_length())
        c = max(2, math.ceil(_SORT_SLACK * s / max(1, k)))
        total += odf * (math.ceil(math.log2(max(s, 2))) * 2 * 12 * s
                        + math.ceil(math.log2(c)) * 2 * 8 * int(_SORT_SLACK * s)
                        + 2 * 2 * 8 * s)
    else:
        total += odf * math.ceil(math.log2(max(s, 2))) * 2 * sort_width * s
    # Scans: the fused kernel reads the 8 B word and writes four int32;
    # XLA's chain makes separate round trips.
    total += odf * scan_bytes * s
    joinmode = expand.startswith("pallas-join")
    if expand.startswith("pallas-vmeta") or vcarry:
        # The fused expansion: four int32 window reads over S and two
        # int32 outputs a slot; vcarry reads and writes the payload planes,
        # vfull the key and right-payload planes too.
        pay_planes = 2 if vcarry else 0
        if vfull:
            total += odf * (28 * s + 24 * bs.out_cap)
        else:
            total += odf * ((16 + 4 * pay_planes) * s + (8 + 4 * pay_planes) * bs.out_cap)
    elif expand.startswith("pallas"):
        # The ranks family: one walk over csum plus int32 outputs (src; src,
        # stag, rstart fused; stag, rtag in join mode); the non-fused,
        # non-join modes add the t scan and the meta gather at src.
        kernel_out = 8 if joinmode else 12 if expand.startswith("pallas-fused") else 4
        total += odf * (4 * s + kernel_out * bs.out_cap)
        if not joinmode and not expand.startswith("pallas-fused"):
            total += odf * (8 + 16) * bs.out_cap
    else:
        # hist: dj_tpu's scatter-add histogram (a hidden sort on the TPU),
        # the cumsum and the meta gather at src.
        total += odf * (math.ceil(math.log2(max(bs.out_cap, 2))) * 2 * 4 * bs.out_cap
                        + 8 * s + 16 * bs.out_cap)
    if vfull:
        total += matches * 24  # output writes only
    elif vcarry:
        total += matches * (16 + 24)  # one stacked gather + output writes
    elif joinmode:
        total += matches * (16 + 8 + 24)  # left and right packs + output writes
    else:
        total += matches * (4 + 16 + 8 + 24)  # rtag, packs, output writes
    if not prepared and plan_tier == "salted" and salt_replicas > 1:
        # The replicas - 1 build copies: their bucketize and compact, and
        # their share of each batch's merged sort and scans.
        sw = 8 if plan.packed else 12
        extra = (salt_replicas - 1) * bs.br
        total += odf * extra * (2 * 2 * 8 + math.ceil(math.log2(max(s, 2))) * 2 * sw
                                + scan_bytes)
    return total
