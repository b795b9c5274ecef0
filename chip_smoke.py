"""Drive dj_tpu_torch's paths on one CUDA card and check them.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its own line(s):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the package, from csrc/, in parallel;
  3. kernels vs plain: join_scans and expand_values against their plain
     PyTorch versions, exact equality, on (a) the main path's own inputs
     at full size, (b) skewed inputs (one hot key on 1M build rows among
     sparse matches, and sparse matches at selectivity 0.001: both must
     give expand_values windows wider than its shared-memory stage, so
     the global-memory search is held to the plain version; S not a
     multiple of the scan tile; join_scans also with 1M probe rows on one
     key, where csum wraps, and twice in a row on the skewed input) and
     (c) an all-miss input; then (d) join_scans alone at S = 4097, 4096,
     4095 (its tile of 4096 positions, +- 1), 31 and 1, each right after
     a call on a larger S, each call logging how far its look-backs read;
  4. unprepared path: generate 100M build x 100M probe int64 rows
     (selectivity 0.3, unique build keys), shard, distributed_inner_join
     at over_decom_factor 1 and 4; every flag False, total equal to the
     generator's expected count, every output row checked against the
     inputs, and both kernels launched by the join itself;
  4b. expansion modes: the same join under each other DJT_JOIN_EXPAND
     mode (ranks, fused, join, vcarry, vfull) at odf 1 and 4, each
     checked as in 4, with the same row multiset as the default (vmeta)
     join and its mode's kernel launched by the join itself; median walls
     of warm joins, peak memory, a profiler breakdown per mode at odf 1;
  4c. kernels vs plain: expand_ranks (at the ranks mode's S and n_out),
     expand_gather, expand_join, expand_carry and expand_vfull against
     their plain versions, exact equality, on the main path's own inputs
     at full size (the vcarry sort's scans, slots and keys, whose csum is
     every mode's; n_out above and below the total) and on edge cases: one
     hot key on 1M build rows (refs 1M positions below their queries)
     amid sparse matches and selectivity 0.001, whose windows must pass
     the shared stage; all-miss; a wrapped csum (expand_ranks must still
     run and keep every slot in [0, S]); 0 to 3 payload slots;
  4d. a 4-rank world on one card: make_topology(["cuda:0"] * 4), the same
     100M x 100M tables sharded over 4 ranks (25M + 25M rows a rank), each
     rank's pipeline on a thread of its own with the bucketed all-to-all
     shuffle between them; distributed_inner_join at odf 1 and 4 (vmeta)
     and at odf 1 under each other expansion mode, then prepare_join_side
     at odf 1 and a query under each merge tier. Each run: every flag of
     every shard False, counts summing to the generator's expected count,
     every row checked against the inputs and co-located (a row on shard r
     has murmur3(key, 12345678) % (4 odf) % 4 == r), the row multiset
     equal to phase 4's, and each expected kernel launched 4 odf times by
     the rank threads; median walls of warm runs, peak memory, and each
     rank's device time by phase (partition, bucketize, the exchange's
     copies, compact, join; CUDA events on the shared stream) beside a
     profiler breakdown by kernel at odf 1;
  4e. the two-level world: 4d's 4 ranks as 2 domains of 2,
     make_topology(["cuda:0"] * 4, intra_size=2), the same tables sharded
     the same way; distributed_inner_join at odf 1 and 4 (the pre-shuffle
     over 'inter', seed 87654321, then the main stage over 'intra') and
     at odf 1 under each other expansion mode; distributed_inner_join_auto
     from pre_shuffle_out_factor 0.5 and bucket_factor 1.0 at growth 2.5
     (pre_shuffle_overflow must heal; attempts and factors logged);
     prepare_join_side at odf 1 and a query under each merge tier. Each
     run: every flag False, counts summing to the generator's count, rows
     checked and equal to phase 4's, each row on shard r in domain
     murmur3(key, 87654321) % 2 == r // 2 and at murmur3(key, 12345678)
     % (2 odf) % 2 == r % 2 there, each kernel launched by the join
     itself; median walls of 3 warm runs, peaks, each rank's device ms by
     phase, the pre-shuffle's apart (dj_pre_shuffle), and a profiler
     breakdown by kernel at odf 1. One card crosses no link: this reads
     the second exchange's cost only;
  4f. shuffle_on of a table shaped as GPU-BDB's web_clickstreams (four
     int64 columns, 100M rows, drawn from the seed on the card: the repo
     has no parquet and the card's machine no pyarrow) on column 0: over
     4d's flat world, then over 4e's 'inter' (seed 87654321) and 'intra'
     axes, and shuffle_on_auto from factors 1.2 / 1.2 on a copy with one
     row in ten on one key (bucket_factor must heal); every row on its
     hash's shard, the row multiset conserved, no overflow; walls, peaks;
  4g. the cascaded wire codec alone: compress_buckets / decompress_buckets
     on the card for each of the 8 cascades (rle x delta x bp) and
     itemsizes 1, 2, 4 and 8 on [4, 1M] buckets in dj_tpu's patterns
     (constant, strided, small range, runs, full range, the width's
     extremes, a walk from the minimum, zeros after an iota) with counts
     below 1M, at wire_factor 1.0: words, totals, overflow bits and
     decodes equal to the same calls on the CPU (in worker threads), each
     bucket that fits decoding to its input, and each RLE decode launching
     expand_ranks once; then the auto-selected cascade of each of 4f's
     columns at 4f's flat bucket shape ([4, 12.5M] int64, half full),
     compress and decompress timed beside their byte bound;
  4e and 4f compressed: 4e's world with each side's auto options
     (broadcast_compression_options) on the pre-shuffle, as
     benchmarks/distributed_join.py --compression: the join at odf 1
     checked as in 4e, the pre_shuffle_comp_* sums, raw/actual and
     wire/raw, walls, the pre-shuffle's device ms and the peak;
     distributed_inner_join_auto from 0.5 / 1.0 at growth 2.5; a prepare
     with right_compression and a sort-tier query with left_compression.
     4f's table shuffled with its auto options flat and per axis, each
     shard equal to the uncompressed shuffle's; with a 0.2 wire on the
     skewed copy the wire alone sets the bucket bit at 1.8 / 2.4 (where
     the raw rows fit) and shuffle_on_auto from 1.2 / 1.2 heals it;
  4h. the join's plan knob: phase 4's join at odf 1 under
     DJT_JOIN_RANGE_PROBE=0, checked as in 4 with the default join's rows
     and launches, its wall beside the default's;
  4i. the skew-adaptive plans in 4d's world under DJT_PLAN_ADAPT=1: (i)
     the broadcast plan by fit at odf 1 and 4 (decision tier and source,
     flags False, rows checked and equal to phase 4's, each row on the
     shard of its probe row, no all-to-all issued, join_scans and
     expand_values once a rank; walls, peak, device ms by phase); (ii)
     the salted plan at odf 1 and 4 under DJT_BROADCAST_BYTES=0, a random
     half of the probe rows on one build key: the salt set and replicas equal to
     the rule re-derived from the gathered counts, the rows equal to the
     shuffle plan's through distributed_inner_join_auto (its heal
     attempts and factors logged beside the salted run's); (iii) a
     replayed decision takes no probe, and 4e's two-level world stays on
     the shuffle plan with 4e's digests;
  warmups: warmup_all_to_all (10 MB) over 4d's world and over both axes
     of 4e's, with its wall;
  4j. a two-stage chain in 4d's world at odf 1 and 4 through
     distributed_join_pipeline: stage 0 probe JOIN build on key 0 (mode
     shuffle), stage 1 the intermediate JOIN a copy of the build table
     hash-partitioned by shuffle_on(..., seed=12345678) over the world
     and declared right_partitioned, which must plan local; plan_pipeline
     probes the chain's three input key columns once and no
     intermediate; every stage's flags False, the total the generator's
     count, the rows equal to phase 4's and to two composed
     distributed_inner_join calls', the local stage issuing no collective
     and launching join_scans and expand_values once a rank (stage 0
     once a rank and batch); at odf 4 the same chain re-shuffled
     (DJT_PIPELINE_COPART=0, DJT_PIPELINE_BROADCAST=0) and the composed
     calls as contrasts (at odf 1 their exchanges peak at 74.8 GB);
     median walls of 3 warm runs, peaks, each rank's device ms by phase
     per stage;
  4k. distributed_inner_join_coalesced_unprepared under
     DJT_SHAPE_BUCKET=1 in 4d's world at odf 1: four member pairs cut
     from 4d's tables at four raw sizes near a fourth of them, all in one
     shape bucket (printed); each member's rows equal its unbucketed
     singleton join's, each source padded once, one exchange epoch for
     the call, DJT_PLAN_ADAPT=1 refused; walls beside four singletons,
     the pad fractions;
  5. prepared path: at odf 1 and 4, prepare_join_side on the build table,
     then distributed_inner_join with the PreparedSide under each merge
     tier (sort, merge, probe); each query checked as in 4, with the
     same row multiset as the unprepared join, and its tier's kernels
     launched by the query itself; median walls of warm prepares and
     queries, peak memory, a profiler breakdown per tier at odf 1;
  5d. the probe tier's expansions: at odf 1 and 4 the probe-tier query
     under DJT_PROBE_EXPAND segment, hist and pallas, each checked as in
     5 and launching its kernel (expand_ranks; expand_values under
     pallas) once a batch; then expand_values as the probe tier calls it
     (stag = arange(L), run_start = 0) against its plain version on the
     tier's own inputs at odf 1, timed beside its byte bound and
     torch.searchsorted, and on one probe row with 1M matches amid
     sparse ones (windows past the shared stage), a batch with no match
     and a csum wrapped past 2^31 (every row in range);
  5c. appends: phase 5's build table prepared at odf 4 takes 1% more rows
     (keys it lacks, drawn from the seed), every batch touched, and a
     query under each tier equals the unprepared join of the combined
     table, flags False (i), and likewise in 4d's 4-rank world (iv);
     rows of batch 0 only touch batch 0 and keep the other batches' tensors
     (ii); at odf 1 the batch has no slack and append_overflow fires (iii);
     a two-level topology is refused (v); the appends' walls beside a
     fresh prepare of the combined table, and the peak;
  5e. the prepared tiers in 4d's world on phase 5's build table: (i)
     DJT_PREPARED_TIER=broadcast and auto (which must pick broadcast) at
     odf 1, one replicated batch a rank, queries under each merge tier
     checked as in 5 with no collective issued and each tier's kernels
     once a rank; prepare and query walls, peaks; (iii) a 1% append to the
     broadcast side re-prepares on its tier, its queries equal to the
     unprepared join of the combined table; (ii) DJT_PREPARED_TIER=salted
     on the build table with 2 of every 5 rows on one key, which one probe
     row carries (about 40M more output rows), with one buffer a
     collective (fuse_columns False): the salt set and replicas
     equal to the rule on the gathered counts, the rows of a query under
     the merge and probe tiers through distributed_inner_join_auto equal
     to the shuffle-prepared side's sort-tier query (attempts and factors
     logged; a salted sort-tier query sorts 400M words a rank, which does
     not fit beside four ranks' resident runs on one card);
  5f. distributed_inner_join_coalesced in 4d's world: K = 4 members, the
     probe table cut into four slices, against phase 5's prepared side
     at odf 1 and 4 under each merge tier, and against 5e's
     broadcast-prepared side at odf 1, at a fourth of phase 5's
     join_out_factor (a member holds a fourth of its rows); each member's rows equal its
     singleton query's and phase 5's rows of its slice, one exchange
     epoch per odf batch (none on the broadcast side), each tier's
     kernels once a member, rank and batch; the first call's wall on a
     fresh side and on one warmed by warmup_prepared_join; the coalesced
     wall beside four singletons and one whole-table query, peaks;
  5b. unsigned columns: a uint16-key and a uint32-key table (keys past
     the signed range) with uint64 payloads (top bit set), about 1M probe
     rows, joined under every DJT_JOIN_EXPAND mode and queried through
     every prepared tier at odf 1 and 4; each result's rows equal, bit for
     bit, those of the int64 join of the same values, and each row's keys
     are checked against the inputs;
  6a. a process world of one (one rank per process) over NCCL:
     init_distributed on a localhost store, make_topology(), then phase
     4's join at odf 1 and 4 with the default backend and at odf 1 with
     RingCommunicator and BufferedCommunicator, and one prepared query
     per merge tier at odf 1; each result's rows equal phase 4's, every
     flag False, each kernel launched once a batch; median walls of warm
     runs and peaks; then the NCCL transport itself on the card's tensors
     (all_to_all, fused and unfused exchange under each backend, the
     chunked all-to-all, shift, all_gather, all_reduce); then, in two
     fresh NCCL worlds of one, the first join's wall without and after
     warmup_all_to_all;
  6b. four processes on this card over gloo (NCCL refuses two ranks on
     one GPU), each generating phase 4's tables from the seed and joining
     its 25M + 25M row block at odf 1 through torch.distributed: each
     process's shard digest (rows and an order-free row hash) equals rank
     r's in phase 4d, the flag matrices are equal on all four; walls and
     each rank's device time by phase (the exchange's among them); then
     the same four processes at intra_size=2 (every 'inter' and 'intra'
     group a torch.distributed subgroup): the odf 1 join, its shard
     digests equal to rank r's in 4e, and 4f's table shuffled over
     'inter' and 'intra', its digests equal to 4f's; each process's auto
     options through broadcast_compression_options over gloo (every
     process ends with rank 0's tree, also for trees made to differ by
     rank), and 4f's table over 'inter' raw and compressed, equal digests,
     each exchange's device ms; and each process, under DJT_PLAN_ADAPT=1,
     decides the broadcast plan on its own and joins once at odf 1: the
     same decision on all four, each shard digest equal to rank r's in
     4i(i); and each process runs 4j's chain at odf 1 on 2M rows a side:
     the same plan (modes, derived ranges) on all four, each shard
     digest equal to rank r's of the chain in a 4-rank world of this
     process;
  6c. an NCCL world of one process per card at phase 4d's rows a rank,
     on a machine with 2 or more cards, with 6b's two-level half when the
     cards factor by 2 (4 or more); with one card, one line saying that
     it did not start and why;
  6. kernels vs plain: merge_sorted_u64 and expand_ranks against their
     plain versions, exact equality, on the prepared path's own inputs at
     full size and on edge cases (cross-operand duplicates with sentinel
     tails, empty and length-1 operands, lengths off the tile, one operand
     wholly above the other; sparse matches whose blocks of slots span
     more than one stage, one row with 1M matches, all-miss, n_out below
     and above the total; for expand_ranks' merge path also S = 0, n_out
     = 0 and 1, and S + n_out at one CTA's items and one either side);
  7a. every fixed-width key kind through distributed_inner_join at odf 1
     on phase 4's tables, keys mapped from the generator's so that the
     expected count is its exact count: uint64 (key + 2^63); two int32
     columns (k >> 16, k & 0xFFFF), packed through the probed range and
     again under DJT_JOIN_PACK=0 (the unpacked sort); float64; int64 with
     a build row at INT64_MIN and a probe row at INT64_MAX (an observed
     span that sorts unpacked); DJT_JOIN_CARRY=1; DJT_JOIN_EXPAND=hist;
     and uint64 under vcarry and vfull, float64 under ranks, fused, join.
     Each: every flag False, the total the expected count, the rows equal
     to phase 4's mapped back, the kernels launched by the join itself,
     the median wall of 3 warm runs and the peak (run after 5b);
  7b. float keys with 100 rows a side at each of -0.0, 0.0, NaN and
     +-inf among 1M: the join on the card equals the port's own join on
     the CPU (total, flags, rows bit for bit);
  7c. distributed_inner_join_auto: join_out_factor 0.05 heals to the
     exact count (attempts and factors logged); a second call under
     DJT_LEDGER, the in-process ledger forgotten, succeeds on attempt 1;
     max_attempts=1 raises CapacityExhausted; in phase 4d's 4-rank world,
     bucket_factor 1.0 with one probe row in ten on one key heals
     shuffle_overflow; a prepared side queried with a probe key below its
     range re-prepares under the sort and the merge tier, its rows equal
     to the unprepared join's;
  8a. string payloads on one GPU's split of TPC-H at scale factor 100 split
     8 ways (the port of scripts/make_tpch_sample.py's make_split: 18.75M
     orders, about 75M lineitems, 1.875M customers, from --seed): orders
     (O_ORDERKEY, O_CUSTKEY, O_ORDERPRIORITY) joined with lineitem
     (L_ORDERKEY, L_PARTKEY, L_QUANTITY) at odf 1 and 4 on one rank and at
     odf 1 in a 4-rank world, char_out_factor 5; every flag False, the
     total the lineitem count, the lineitem columns equal to lineitem's
     rows, every O_CUSTKEY and priority the one its orderkey was drawn
     with (checked on the card, byte for byte); join_scans and
     expand_values launched once a rank and batch; walls, peak, and the
     device ms of each string pass (StringColumn.take, the string hash,
     the char bucketize and compact, the verifier) from CUDA events;
  8b. distributed_inner_join_auto on 8a's tables at char_out_factor 1:
     char_overflow heals (attempts and the factor logged), the rows check
     as in 8a, and a second call takes one attempt through the ledger;
  8c. a string key: orders keyed by the C_NAME of O_CUSTKEY ("Customer#"
     and 9 digits, 18 bytes) joined with customer keyed by C_NAME, with
     C_MKTSEGMENT as the string payload, on one rank and in the 4-rank
     world; the total the host's count of orders of split 0's customers,
     surrogate_collision False, every row's key, custkeys and segment
     checked, world rows on their key's _string_hash shard;
  8d. the verifier: a 1M-row string-key join under a surrogate weakened
     to ignore the first byte ("Customer#k" and "Dustomer#k" collide)
     flags surrogate_collision, a true match under it does not, and
     distributed_inner_join_auto raises the collision after one attempt;
  8f. 8c's 4-rank join under DJT_PLAN_ADAPT=1: customer, the build side,
     broadcast to every rank (its two string columns as two buffers
     each), no all-to-all, every row checked as in 8c; wall, peak and the
     string passes' device ms beside 8c's world;
  8e. the prepared side with strings: orders prepared, lineitem queried
     under each tier at odf 1 and 4 on one rank and odf 1 in the 4-rank
     world, char_out_factor 5, each checked as 8a (priorities byte for
     byte) with each tier's kernels launched once a rank and batch;
     distributed_inner_join_auto from char_out_factor 1 heals
     char_overflow on the prepared path; 1M orders held back from the
     prepare are appended with their priorities and the queries checked
     as 8a again; a string key raises dj_tpu's ValueError;
  8g. TPC-H Q3's joins as one pipeline, as benchmarks/tpch.py --q3 runs
     them (distributed_join_pipeline_auto, every stage auto): lineitem
     JOIN orders on the orderkey, then the intermediate JOIN customer on
     O_CUSTKEY, O_ORDERPRIORITY and C_MKTSEGMENT string payloads, on one
     rank and in the 4-rank world, stage 1 planned broadcast; the rows
     equal two composed distributed_inner_join_auto calls', each row's
     orderkey, custkey and both strings checked against the tables, no
     all-to-all in stage 1, flags False; heal attempts and factors per
     stage, walls, the peak and the string passes' device ms;
  9. timings: the `timings` line (walls, peaks and the main path's sort);
  10. the hardware probes: `python -m dj_tpu_torch.hw.probe_sort` and
     `... .probe_gather` through their main() at the JAX probes' shapes
     (64 tiles of 32768 u32 words; N = 131072 int32), each printing
     CORRECT and launching its kernels (the gather: the L2 gather `run`
     and the cluster gather `run_cluster`); then tile_sort at the join's
     scale (6104 tiles, 200,015,872 words) against its plain version,
     beside the flat sort of the same words;
  10b. kernels vs plain: tile_sort, `run` and `run_cluster` against their
     plain versions, exact equality, on the probes' shapes and on edge
     cases (words >= 2^31, all equal to the padding, sorted, reverse
     sorted, heavy duplicates, TILE 20000, 1025, 1024, 1023, 33, 32, 31,
     3 and 1, around a thread's 32 words and a warp's 1024; indices
     negative and outside [-N, N), N not a multiple of the cluster, the
     largest N `run_cluster` admits, N = 1; `run` alone past that N, at
     N = 10,000,003, at N not a multiple of 4 and with idx off 16-byte
     alignment), and tile_sort and `run_cluster` refusing a size their
     kernels cannot hold;
then the `kernels` JSON line (kernel, plain-version and library times
beside each kernel's bound, launches per query on each path and in the
4-rank world (the plan tiers of 4i, 5e and 8f and the composition
layers' 4j, 4k and 5f among its paths), its two-level form and the
process worlds (6b's broadcast run and chain apart), expand_ranks'
codec decodes in 4g, expand_values' probe-tier call of 5d, and each
kernel's registers and spills from ptxas; the probes' launches are their
main()'s, and no join path launches them).
The last line is {"ok": true, "device": {...}}. With no CUDA device, or
without the package beside it, the script fails before printing any
result. ``--rows N`` shrinks the main path and ``--orders N`` phase 8's
split (for a quick first check). The `total` line gives the command's
seconds.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import json
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def packed_inputs(build, probe, device):
    """The sorted packed words inner_join builds for probe JOIN build."""
    from dj_tpu_torch.ops.join import _single_key_pack
    from dj_tpu_torch.ops.merge import sort_u64

    lk, rk = probe.columns[0].data, build.columns[0].data
    L, R = lk.shape[0], rk.shape[0]
    tag_bits = max(1, (L + R).bit_length())
    lc = torch.tensor(L, dtype=torch.int32, device=device)
    rc = torch.tensor(R, dtype=torch.int32, device=device)
    packed = _single_key_pack(lk, rk, lc, rc, tag_bits, None)
    if packed.word is None:
        raise AssertionError("packed_inputs: the keys' span does not fit the packed word")
    return sort_u64(packed.word), lc, rc, tag_bits, L, R


def max_abs_diff(pairs) -> int:
    """Largest |got - want| over (got, want) int32 pairs, in int64."""
    return max((int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0)
               for g, w in pairs)


def block_windows(csum, n_out: int, total: int) -> tuple[int, int]:
    """(widest window, blocks whose window is wider than WIN) over the
    expand_values blocks that own a slot below total. Block b owns slots
    [j0, j_last] and searches merged positions [#{csum <= j0}, #{csum <=
    j_last}); a window wider than WIN is searched in global memory."""
    from dj_tpu_torch.ops.expand import ETILE, WIN

    j0 = torch.arange(0, min(total, n_out), ETILE, dtype=torch.int32, device=csum.device)
    if not j0.numel():
        return 0, 0
    j_last = torch.clamp_max(j0 + (ETILE - 1), n_out - 1)
    width = (torch.searchsorted(csum, j_last, right=True)
             - torch.searchsorted(csum, j0, right=True))
    return int(width.max()), int((width > WIN).sum())


def check_scans(case: str, got, want) -> None:
    """Every slot of join_scans' four outputs equal to the plain version's."""
    for name, g, w in zip(("stag", "run_start", "cnt", "csum"), got, want):
        bad = torch.nonzero(g != w).flatten()
        if bad.numel():
            b = int(bad[0])
            raise AssertionError(f"{case}: join_scans {name} differs at {bad.numel()} of {g.numel()} "
                                 f"positions, first at {b}: {int(g[b])} vs {int(w[b])}")


def compare_scans(case: str, sp, lc, rc, tag_bits, L, R, calls: int = 1):
    """join_scans against its plain version, every slot of every output
    equal, over ``calls`` calls in a row on the same input (each must
    equal the plain version: stale look-back state would not); logs the
    deepest look-back of the last call and returns (its outputs, 0)."""
    from dj_tpu_torch.ops import scan

    want = scan.join_scans_plain(sp, lc, rc, tag_bits, L, R)
    for i in range(calls):
        got = scan.join_scans(sp, lc, rc, tag_bits, L, R)
        torch.cuda.synchronize()
        check_scans(f"{case} (call {i + 1} of {calls})", got, want)
    depth = scan.lookback_depth()
    for k in ("run_max", "csum_max"):
        LOOKBACK[k] = max(LOOKBACK[k], depth[k])
    log("scans_vs_plain", case=case, S=L + R, tiles=-(-(L + R) // scan.TILE), calls=calls,
        max_abs_err=0, positions_equal=L + R, lookback_tiles=depth)
    return got, 0


LOOKBACK = {"run_max": 0, "csum_max": 0}  # the deepest look-backs of any compared call


def compare_kernels(case: str, sp, lc, rc, tag_bits, L, R, n_out, timing: bool,
                    need_global_windows: bool = False):
    """join_scans and expand_values against their plain versions; returns
    the two kernels' max |kernel - plain| and, with ``timing``, times."""
    from dj_tpu_torch.ops import expand, scan

    got, scan_err = compare_scans(case, sp, lc, rc, tag_bits, L, R)
    stag, run_start, cnt, csum = got
    total = int(cnt.sum(dtype=torch.int64))
    sj, rp = expand.expand_values(csum, cnt, stag, run_start, n_out)
    wsj, wrp = expand.expand_values_plain(csum, cnt, stag, run_start, n_out)
    torch.cuda.synchronize()
    # Past 2^31 matches the int32 csum wraps (as the TPU kernel's does):
    # it is no longer sorted and every expansion slot is unspecified.
    wrapped = total > 2**31 - 1
    k = 0 if wrapped else min(total, n_out)
    exp_err = max_abs_diff(((sj[:k], wsj[:k]), (rp[:k], wrp[:k])))
    if exp_err:
        for name, g, w in (("stag_j", sj[:k], wsj[:k]), ("rpos", rp[:k], wrp[:k])):
            if bool((g != w).any()):
                bad = int(torch.nonzero(g != w)[0])
                raise AssertionError(f"{case}: expand_values {name} differs first at {bad}: {int(g[bad])} vs {int(w[bad])} (max |err| {exp_err})")
    del sj, rp, wsj, wrp
    widest, n_global = (0, 0) if wrapped else block_windows(csum, n_out, total)
    if need_global_windows and not n_global:
        raise AssertionError(f"{case}: no expand_values window is wider than "
                             f"{expand.WIN} (widest {widest}); the global-memory search was not exercised")
    S = L + R
    log("kernels_vs_plain", case=case, S=S, n_out=n_out, total=total,
        S_mod_tile=S % scan.TILE, join_scans_max_abs_err=scan_err,
        expand_values=f"max |err| {exp_err} on {k} slots" if not wrapped
        else "not compared: csum wrapped past 2^31, every slot unspecified",
        widest_window=widest, blocks_over_win=n_global)
    if not timing:
        return scan_err, exp_err
    reps = 5
    t = {
        "scan_ms": cuda_ms(lambda: scan.join_scans(sp, lc, rc, tag_bits, L, R), reps),
        "scan_plain_ms": cuda_ms(lambda: scan.join_scans_plain(sp, lc, rc, tag_bits, L, R), 2),
        "expand_ms": cuda_ms(lambda: expand.expand_values(csum, cnt, stag, run_start, n_out), reps),
        "expand_plain_ms": cuda_ms(lambda: expand.expand_values_plain(csum, cnt, stag, run_start, n_out), 2),
    }
    j = torch.arange(n_out, dtype=torch.int32, device=sp.device)
    t["searchsorted_ms"] = cuda_ms(lambda: torch.searchsorted(csum, j, right=True, out_int32=True), reps)
    del j
    # What one single-pass scan of S int32 takes on this card (a
    # yardstick, not the same function).
    t["cumsum_ms"] = cuda_ms(lambda: torch.cumsum(cnt, 0, dtype=torch.int32), reps)
    word = sp.clone()
    t["sort_ms"] = cuda_ms(lambda: torch.sort(word), 3)
    del word
    t.update(S=S, n_out=n_out)
    return scan_err, exp_err, t


def profile_join(run, **labels) -> None:
    """Device time of one warm join by kernel (torch.profiler), and the
    device's idle share of the join's wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    log("profile", **labels, wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=(1 - busy_ms / wall_ms) if busy_ms else "not measured",
        top=[{"kernel": k[:90], "ms": ms, "calls": n} for k, (ms, n) in top])


def check_rows(out, counts, build, probe, expected: int) -> None:
    """Every output row (k, lp, rp): probe_key[lp] == k, build_key[rp]
    == k, and no probe row appears twice (build keys are unique)."""
    n = int(counts[0])
    if n != expected:
        raise AssertionError(f"join total {n} != expected {expected}")
    k, lp, rp = (c.data[:n] for c in out.columns)
    if not bool((probe.columns[0].data[lp] == k).all()):
        raise AssertionError("a row's probe key differs from its key column")
    if not bool((build.columns[0].data[rp] == k).all()):
        raise AssertionError("a row's build key differs from its key column")
    s = torch.sort(lp).values
    if n > 1 and bool((s[1:] == s[:-1]).any()):
        raise AssertionError("a probe row appears in two output rows")


TIERS = ("sort", "merge", "probe")
MODES = ("ranks", "fused", "join", "vcarry", "vfull")  # besides the default vmeta
# Each kernel's launch counter in dj_tpu_torch.ops.expand.
EXPAND_COUNTERS = {"expand_values": "launches", "expand_ranks": "ranks_launches",
                   "expand_gather": "gather_launches", "expand_join": "join_launches",
                   "expand_carry": "carry_launches", "expand_vfull": "vfull_launches"}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from dj_tpu_torch.ops import expand, merge, scan

    scan.launches = merge.launches = 0
    for counter in EXPAND_COUNTERS.values():
        setattr(expand, counter, 0)


def read_launches() -> dict:
    from dj_tpu_torch.ops import expand, merge, scan

    return {"join_scans": scan.launches, "merge_sorted_u64": merge.launches,
            **{name: getattr(expand, c) for name, c in EXPAND_COUNTERS.items()}}


def carry_inputs(build, probe, device):
    """The mode kernels' inputs for probe JOIN build as inner_join makes
    them under vcarry: (csum, cnt, stag, run_start, slots, key) from the
    sort that carries every non-key column as a union u64 slot."""
    from dj_tpu_torch.ops.join import _carry_sorted, _single_key_pack, _union_slots
    from dj_tpu_torch.ops.scan import join_scans

    lk, rk = probe.columns[0].data, build.columns[0].data
    L, R = lk.shape[0], rk.shape[0]
    tag_bits = max(1, (L + R).bit_length())
    lc = torch.tensor(L, dtype=torch.int32, device=device)
    rc = torch.tensor(R, dtype=torch.int32, device=device)
    slots = _union_slots(list(enumerate(probe.columns))[1:], list(enumerate(build.columns))[1:],
                         L, R, device)
    sp, key, sslots = _carry_sorted(_single_key_pack(lk, rk, lc, rc, tag_bits, None), lk.dtype,
                                    tag_bits, slots)
    stag, run_start, cnt, csum = join_scans(sp, lc, rc, tag_bits, L, R)
    return csum, cnt, stag, run_start, sslots, key


def compare_modes(case: str, inputs, n_out: int, timing: bool = False,
                  need_global_windows: bool = False, min_ref_distance: int = 0):
    """expand_ranks (the ranks mode's src), expand_gather, expand_join,
    expand_carry and expand_vfull against their plain versions on every
    slot below min(total, n_out), expand_ranks on every slot (none when
    csum wrapped past 2^31: every slot is then unspecified); returns
    {kernel: max |kernel - plain|} (0, or it raises) and, with
    ``timing``, each kernel's and plain version's times and the library
    yardstick's."""
    from dj_tpu_torch.ops import expand

    csum, cnt, stag, run_start, slots, key = inputs
    total = int(cnt.sum(dtype=torch.int64))
    wrapped = total > 2**31 - 1
    k = 0 if wrapped else min(total, n_out)
    calls = {
        "expand_ranks": (csum, n_out),
        "expand_gather": (csum, stag, run_start, n_out),
        "expand_join": (csum, stag, run_start, n_out),
        "expand_carry": (csum, cnt, run_start, slots, n_out),
        "expand_vfull": (csum, cnt, run_start, slots, key, n_out),
    }
    for name, a in calls.items():
        got = getattr(expand, name)(*a)
        want = getattr(expand, name + "_plain")(*a)
        torch.cuda.synchronize()
        if name == "expand_ranks":
            # One output, specified on every slot (past the total it is S).
            got, want, kn = (got,), (want,), 0 if wrapped else n_out
            if wrapped and not bool(((got[0] >= 0) & (got[0] <= csum.numel())).all()):
                raise AssertionError(f"{case}: expand_ranks wrote a slot outside [0, S] "
                                     f"on the wrapped csum")
        else:
            kn = k
        for i, (g, w) in enumerate(zip(got, want)):
            bad = torch.nonzero(g[:kn] != w[:kn]).flatten()
            if bad.numel():
                b = int(bad[0])
                raise AssertionError(f"{case}: {name} output {i} differs at {bad.numel()} of {kn} "
                                     f"slots, first at {b}: {int(g[b])} vs {int(w[b])}")
        del got, want
    widest, n_global = (0, 0) if wrapped else block_windows(csum, n_out, total)
    if need_global_windows and not n_global:
        raise AssertionError(f"{case}: no window is wider than {expand.WIN} (widest {widest}); "
                             f"the global-memory search was not exercised")
    # How far below its query the farthest matched ref sits.
    pos = torch.arange(csum.numel(), device=csum.device)
    ref_distance = int(torch.where(cnt > 0, pos - run_start, 0).max())
    if ref_distance < min_ref_distance:
        raise AssertionError(f"{case}: farthest ref {ref_distance} below its query, "
                             f"expected at least {min_ref_distance}")
    log("kernels_vs_plain", case=case, kernels=sorted(calls), S=csum.numel(), n_out=n_out,
        total=total, payload_slots=len(slots), max_abs_err=0,
        slots_compared=k if not wrapped else "none: csum wrapped past 2^31, every slot unspecified",
        widest_window=widest, blocks_over_win=n_global, farthest_ref=ref_distance)
    errs = {name: 0 for name in calls}
    if not timing:
        return errs
    t = {}
    for name, a in calls.items():
        fn, plain = getattr(expand, name), getattr(expand, name + "_plain")
        t[name] = {"ms": cuda_ms(lambda: fn(*a), 5), "plain_ms": cuda_ms(lambda: plain(*a), 2)}
    j = torch.arange(n_out, dtype=torch.int32, device=csum.device)
    t["searchsorted_ms"] = cuda_ms(lambda: torch.searchsorted(csum, j, right=True, out_int32=True), 5)
    t.update(S=csum.numel(), n_out=n_out, n_slots=len(slots))
    return errs, t


def sorted_rows(out, counts):
    """The valid output rows (key, probe row, build row) ordered by probe
    row: build keys are unique, so the probe row identifies a row."""
    n = int(counts[0])
    k, lp, rp = (c.data[:n] for c in out.columns)
    order = torch.sort(lp).indices
    return k[order], lp[order], rp[order]


def check_same_rows(got, want, what: str) -> None:
    for g, w, name in zip(got, want, ("key", "probe row", "build row")):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: the {name} column differs from the default join's "
                                 f"(unprepared, vmeta)")


def probe_tier_inputs(prep, left, lcnt):
    """At odf 1 the query's probe batch is the probe shard itself: its
    resident words, the probe words packed under the plan, and the
    probe tier's int32 csum, as the query computes them."""
    from dj_tpu_torch.ops.join import _anchored_pack_word, _probe_counts

    pwords, _, pcnt = prep.batches[0]
    w_l, _ = _anchored_pack_word(left.with_count(lcnt[0]), [0], prep.plan, pwords.shape[0])
    _, cnt = _probe_counts(pwords, w_l, lcnt[0], pcnt[0], prep.plan.tag_bits)
    return pwords, w_l, torch.cumsum(cnt, 0, dtype=torch.int64).to(torch.int32)


def compare_merge(case: str, a, b, timing: bool = False):
    """merge_sorted_u64 against its plain version, every word equal;
    returns the max |kernel - plain| (0, or it raises) and, with
    ``timing``, the kernel's, plain version's and library sort's times."""
    from dj_tpu_torch.ops import merge

    got = merge.merge_sorted_u64(a, b)
    want = merge.merge_sorted_u64_plain(a, b)
    torch.cuda.synchronize()
    bad = torch.nonzero(got != want).flatten()
    if bad.numel():
        i = int(bad[0])
        raise AssertionError(f"{case}: merge_sorted_u64 differs at {bad.numel()} of {got.numel()} "
                             f"words, first at {i}: {int(got[i]):#x} vs {int(want[i]):#x}")
    S = a.numel() + b.numel()
    log("kernels_vs_plain", case=case, kernel="merge_sorted_u64", R=a.numel(), L=b.numel(),
        S_mod_tile=S % merge.TILE, max_abs_err=0, words_equal=S)
    del got, want
    if not timing:
        return 0
    flipped = torch.cat([a, b]) ^ (-(2**63))
    t = {"ms": cuda_ms(lambda: merge.merge_sorted_u64(a, b), 5),
         "plain_ms": cuda_ms(lambda: merge.merge_sorted_u64_plain(a, b), 2),
         "library_ms": cuda_ms(lambda: torch.sort(flipped), 3), "S": S}
    return 0, t


def compare_ranks(case: str, csum, n_out: int, timing: bool = False,
                  need_global_windows: bool = False):
    """expand_ranks against its plain version on every slot; returns
    the max |kernel - plain| and, with ``timing``, times."""
    from dj_tpu_torch.ops import expand

    got = expand.expand_ranks(csum, n_out)
    want = expand.expand_ranks_plain(csum, n_out)
    torch.cuda.synchronize()
    err = max_abs_diff([(got, want)])
    if err:
        i = int(torch.nonzero(got != want)[0])
        raise AssertionError(f"{case}: expand_ranks differs first at {i}: {int(got[i])} vs "
                             f"{int(want[i])} (max |err| {err})")
    total = int(csum[-1]) if csum.numel() else 0
    widest, n_global = block_windows(csum, n_out, total) if n_out else (0, 0)
    if need_global_windows and not n_global:
        raise AssertionError(f"{case}: no block of {expand.ETILE} slots spans more than "
                             f"{expand.WIN} rows (widest {widest}); the case no longer spans "
                             f"more than one stage")
    log("kernels_vs_plain", case=case, kernel="expand_ranks", S=csum.numel(), n_out=n_out,
        total=total, max_abs_err=err, slots_compared=n_out, widest_window=widest,
        blocks_over_win=n_global)
    del got, want
    if not timing:
        return err
    j = torch.arange(n_out, dtype=torch.int32, device=csum.device)
    t = {"ms": cuda_ms(lambda: expand.expand_ranks(csum, n_out), 5),
         "plain_ms": cuda_ms(lambda: expand.expand_ranks_plain(csum, n_out), 2),
         "library_ms": cuda_ms(lambda: torch.searchsorted(csum, j, right=True, out_int32=True), 5),
         "S": csum.numel(), "n_out": n_out}
    return err, t


def unsigned_tables(dj, gen, dev, n: int, key_dtype):
    """(build, probe, key_range, int64 build, int64 probe) for a join on
    ``key_dtype`` keys past the signed range (uint16: 40,000 unique
    build keys in [25536, 65536); uint32: n unique build keys in
    [2^32 - 2n, 2^32)), about half the n probe keys matching, and one
    uint64 payload a side holding the row index plus 2^63. The int64
    tables carry the same values (payloads as the same bits)."""
    span = 40_000 if key_dtype == torch.uint16 else 2 * n
    lo = (1 << (8 * torch.empty((), dtype=key_dtype).element_size())) - span
    n_build = min(n, span)
    bk = lo + torch.randperm(span, generator=gen, device=dev)[:n_build]
    pk = lo + torch.randint(0, span, (n,), generator=gen, device=dev)
    udt = dj.dtypes.uint16 if key_dtype == torch.uint16 else dj.dtypes.uint32
    tables = []
    for keys in (bk, pk):
        pay = torch.arange(keys.numel(), device=dev) ^ (-(2**63))
        tables.append((dj.Table((dj.Column(keys.to(key_dtype), udt),
                                 dj.Column(pay.view(torch.uint64), dj.dtypes.uint64))),
                       dj.Table((dj.Column(keys, dj.dtypes.int64), dj.Column(pay, dj.dtypes.int64)))))
    (build, build64), (probe, probe64) = tables
    return build, probe, (lo, lo + span - 1), build64, probe64


def unsigned_rows(out, counts):
    """The valid output rows (key, probe payload, build payload) as int64
    bits, ordered by the probe payload (unique per probe row)."""
    n = int(counts[0])
    k, lp, rp = (c.data[:n] for c in out.columns)
    lp, rp = lp.view(torch.int64), rp.view(torch.int64)
    order = torch.sort(lp).indices
    return k.to(torch.int64)[order], lp[order], rp[order]


def check_unsigned_path(dj, topo, gen, dev, n: int) -> None:
    """Phase 5b: unsigned keys and payloads through every expansion mode
    and every prepared tier, each result equal to the int64 join."""
    results = []
    for key_dtype in (torch.uint16, torch.uint32):
        build, probe, key_range, build64, probe64 = unsigned_tables(dj, gen, dev, n, key_dtype)
        right, rcnt = dj.shard_table(topo, build)
        left, lcnt = dj.shard_table(topo, probe)
        r64, rc64 = dj.shard_table(topo, build64)
        l64, lc64 = dj.shard_table(topo, probe64)
        out, counts, _ = dj.distributed_inner_join(topo, l64, lc64, r64, rc64, [0], [0], dj.JoinConfig())
        ref = unsigned_rows(out, counts)
        k, lp, rp = ref
        bkeys, pkeys = build64.columns[0].data, probe64.columns[0].data
        expected = int(torch.isin(pkeys, bkeys).sum())
        if k.numel() != expected:
            raise AssertionError(f"{key_dtype} int64 join: {k.numel()} rows, expected {expected}")
        if not (bool((pkeys[lp ^ (-(2**63))] == k).all())
                and bool((bkeys[rp ^ (-(2**63))] == k).all())):
            raise AssertionError(f"{key_dtype} int64 join: a row's keys differ from its inputs")
        del out, counts, l64, lc64, r64, rc64

        def check(what, out, counts, info):
            set_flags = [f for f, v in info.items() if bool(v.any())]
            if set_flags:
                raise AssertionError(f"{what}: flags set: {set_flags}")
            if [c.data.dtype for c in out.columns] != [key_dtype, torch.uint64, torch.uint64]:
                raise AssertionError(f"{what}: column dtypes {[c.data.dtype for c in out.columns]}")
            got = unsigned_rows(out, counts)
            for g, w, name in zip(got, ref, ("key", "probe payload", "build payload")):
                if g.shape != w.shape or not torch.equal(g, w):
                    raise AssertionError(f"{what}: the {name} column differs from the int64 join's")
            results.append(what)

        for odf in (1, 4):
            cfg = dj.JoinConfig(over_decom_factor=odf)
            for mode in ("vmeta",) + MODES:
                os.environ["DJT_JOIN_EXPAND"] = mode
                check(f"{key_dtype} mode={mode} odf={odf}",
                      *dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg))
            os.environ.pop("DJT_JOIN_EXPAND")
            pcfg = dj.JoinConfig(over_decom_factor=odf, key_range=key_range)
            prep = dj.prepare_join_side(topo, right, rcnt, [0], pcfg, left_capacity=n)
            for tier in TIERS:
                os.environ["DJT_JOIN_MERGE"] = tier
                check(f"{key_dtype} prepared tier={tier} odf={odf}",
                      *dj.distributed_inner_join(topo, left, lcnt, prep, None, [0], None, pcfg))
            os.environ.pop("DJT_JOIN_MERGE")
            del prep
        log("unsigned_path", key=str(key_dtype), payload="torch.uint64", probe_rows=n,
            build_rows=build.capacity, total=expected, key_range=list(key_range),
            same_rows_as_int64_join=[r for r in results if r.startswith(str(key_dtype))])
        del build, probe, build64, probe64, left, lcnt, right, rcnt, ref, k, lp, rp


INT64_MIN, INT64_MAX = -(2**63), 2**63 - 1
# Phase 7a's key kinds: the generator's int64 keys mapped into each; a
# "+mode" suffix runs the kind under that DJT_JOIN_EXPAND mode (the
# uint64 key recovered from the packed word by vcarry and vfull, and the
# unpacked sort's words read by the other kernel modes).
KEY_KINDS = ("uint64", "two_int32_packed", "two_int32_unpacked", "float64", "int64_extremes",
             "carry", "hist", "uint64+vcarry", "uint64+vfull", "float64+ranks", "float64+fused",
             "float64+join")
# The merged sort each kind's join takes (int64_extremes: the probed
# range spans 64 bits, so the plan sorts unpacked).
KIND_SORTS = {"uint64": "packed", "two_int32_packed": "packed, two fields",
              "two_int32_unpacked": "unpacked, two stable passes", "float64": "unpacked",
              "int64_extremes": "unpacked", "carry": "unpacked, one slot", "hist": "packed"}


def key_kind_tables(dj, kind: str, build, probe):
    """(build, probe, key columns, env, back) of one phase 7a kind: the
    generator's tables with their int64 keys k mapped into the kind
    (uint64 k + 2^63; two int32 columns (k >> 16, k & 0xFFFF); float64;
    int64 with one build row at INT64_MIN and one probe row at INT64_MAX
    added, which match nothing), so the expected count stays the
    generator's; ``env`` holds the knobs the kind runs under and
    ``back(key columns)`` maps an output's keys back to int64."""
    kind, _, mode = kind.partition("+")
    env = {"two_int32_unpacked": {"DJT_JOIN_PACK": "0"}, "carry": {"DJT_JOIN_CARRY": "1"},
           "hist": {"DJT_JOIN_EXPAND": "hist"}}.get(kind, {})
    if mode:
        env = {"DJT_JOIN_EXPAND": mode}

    def keys(k):
        if kind == "uint64":
            return [dj.Column((k ^ INT64_MIN).view(torch.uint64), dj.dtypes.uint64)]
        if kind.startswith("two_int32"):
            return [dj.Column((k >> 16).to(torch.int32), dj.dtypes.int32),
                    dj.Column((k & 0xFFFF).to(torch.int32), dj.dtypes.int32)]
        if kind == "float64":
            return [dj.Column(k.to(torch.float64), dj.dtypes.float64)]
        return [dj.Column(k, dj.dtypes.int64)]

    def back(cols):
        if kind == "uint64":
            return cols[0].view(torch.int64) ^ INT64_MIN
        if kind.startswith("two_int32"):
            return (cols[0].to(torch.int64) << 16) | cols[1].to(torch.int64)
        return cols[0].to(torch.int64)

    tables = []
    for t, extreme in ((build, INT64_MIN), (probe, INT64_MAX)):
        k, pay = t.columns[0].data, t.columns[1].data
        if kind == "int64_extremes":
            k = torch.cat([k, torch.tensor([extreme], device=k.device)])
            pay = torch.cat([pay, torch.tensor([pay.numel()], device=k.device)])
        tables.append(dj.Table(tuple(keys(k)) + (dj.Column(pay, dj.dtypes.int64),)))
    n_keys = 2 if kind.startswith("two_int32") else 1
    return tables[0], tables[1], n_keys, env, back


def kind_rows(out, counts, n_keys: int, back):
    """The valid rows (int64 key, probe row, build row) ordered by probe
    row, as sorted_rows gives phase 4's."""
    n = int(counts.sum())
    cols = [c.data[:n] for c in out.columns]
    lp, rp = cols[n_keys], cols[n_keys + 1]
    order = torch.sort(lp).indices
    return back(cols[:n_keys])[order], lp[order], rp[order]


def run_key_kinds(dj, topo, build, probe, expected: int, ref, smi: str) -> dict:
    """Phase 7a: the one-rank join at odf 1 on each new key kind, checked
    against phase 4's rows. Returns {path: {1: launches}}."""
    from dj_tpu_torch.ops.join import EXPAND_KERNELS, join_plan
    from dj_tpu_torch.parallel.dist_join import _resolve_key_range

    launch_table = {}
    for kind in KEY_KINDS:
        b, p, n_keys, env, back = key_kind_tables(dj, kind, build, probe)
        right, rcnt = dj.shard_table(topo, b)
        left, lcnt = dj.shard_table(topo, p)
        del b, p
        on = list(range(n_keys))
        cfg = dj.JoinConfig()
        what = f"7a kind={kind}"
        base = kind.partition("+")[0]
        os.environ.update(env)
        try:
            # The plan the join resolves: the key range it probes, then
            # the local join's resolver on the one rank's (whole) batch.
            key_range = _resolve_key_range(cfg, left, lcnt, right, rcnt, on, on, 1, topo)
            plan = join_plan(left, right, on, on, key_range)
            if plan.packed != KIND_SORTS[base].startswith("packed"):
                raise AssertionError(f"{what}: the plan {plan} does not take the "
                                     f"{KIND_SORTS[base]} sort")
            need = ("join_scans",) + tuple(EXPAND_KERNELS[m] for m in (plan.expand,)
                                           if m in EXPAND_KERNELS)

            def join():
                return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, on, on, cfg)

            reset_launches()
            out, counts, info = join()
            torch.cuda.synchronize()
            launches = read_launches()
            set_flags = [f for f, v in info.items() if bool(v.any())]
            if set_flags:
                raise AssertionError(f"{what}: flags set: {set_flags}")
            if int(counts.sum()) != expected:
                raise AssertionError(f"{what}: total {int(counts.sum())} != expected {expected}")
            check_same_rows(kind_rows(out, counts, n_keys, back), ref, what)
            del out, counts, info
            if min(launches[k] for k in need) < 1:
                raise AssertionError(f"{what}: {need} not launched by the join: {launches}")
            wall, runs, peak = warm_walls(join)
            if kind in ("float64", "two_int32_unpacked", "carry"):
                profile_join(join, path=f"key_{kind}", odf=1)
        finally:
            for k in env:
                os.environ.pop(k)
        launch_table[f"key_{kind}"] = {1: launches}
        log("key_kind", smoke_phase="7a", kind=kind, key_dtypes=[str(c.data.dtype) for c in
            left.columns[:n_keys]], env=env, plan=plan._asdict(), sort=KIND_SORTS[base],
            rows=left.capacity,
            build_rows=right.capacity, odf=1, total=expected, flags="all False",
            same_rows_as_phase_4=True, launches=launches, wall_ms=wall, wall_ms_runs=runs,
            peak_bytes=peak, card=smi)
        del left, lcnt, right, rcnt
        torch.cuda.empty_cache()
    return launch_table


def float_special_tables(dj, gen, dev, n: int):
    """(build, probe) of n float64 keys in [0, 2n) each, 100 rows a side
    set to each of -0.0, 0.0, NaN, +inf and -inf, and an int64 row id."""
    tables = []
    for _ in range(2):
        k = torch.randint(0, 2 * n, (n,), generator=gen, device=dev).to(torch.float64)
        idx = torch.randperm(n, generator=gen, device=dev)[:500].view(5, 100)
        for row, v in zip(idx, (-0.0, 0.0, float("nan"), float("inf"), float("-inf"))):
            k[row] = v
        tables.append(dj.Table((dj.Column(k, dj.dtypes.float64),
                                dj.Column(torch.arange(n, device=dev), dj.dtypes.int64))))
    return tables


def check_float_specials(dj, gen, dev, n: int, smi: str) -> dict:
    """Phase 7b: float keys with -0.0, 0.0, NaN and +-inf joined on the
    card and by the port on the CPU: the same total, flags and rows, bit
    for bit (-0.0 joins 0.0 and keeps its sign in the left key column;
    NaN joins nothing)."""
    build, probe = float_special_tables(dj, gen, dev, n)
    results = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        topo = dj.make_topology([device])
        b = dj.Table(tuple(dj.Column(c.data.to(device), c.dtype) for c in build.columns))
        p = dj.Table(tuple(dj.Column(c.data.to(device), c.dtype) for c in probe.columns))
        right, rcnt = dj.shard_table(topo, b)
        left, lcnt = dj.shard_table(topo, p)
        reset_launches()
        out, counts, info = dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0])
        launches = read_launches()
        total = int(counts.sum())
        k, lp, rp = (c.data[:total].cpu() for c in out.columns)
        order = torch.sort(lp * (n + 1) + rp).indices
        results[where] = (total, {f: v.tolist() for f, v in info.items()},
                          k.view(torch.int64)[order], lp[order], rp[order], launches)
    card, cpu = results["card"], results["cpu"]
    if card[0] != cpu[0] or card[1] != cpu[1]:
        raise AssertionError(f"7b: card total/flags {card[:2]} != the CPU's {cpu[:2]}")
    for g, w, name in zip(card[2:5], cpu[2:5], ("key bits", "probe row", "build row")):
        if not torch.equal(g, w):
            raise AssertionError(f"7b: the {name} column differs from the CPU join's")
    keys = card[2].view(torch.float64)
    zeros = int((keys == 0).sum())
    if bool(torch.isnan(keys).any()) or zeros < 100 * 100 or card[5]["join_scans"] < 1:
        raise AssertionError(f"7b: NaN rows or too few zero matches ({zeros}): {card[5]}")
    log("float_specials", smoke_phase="7b", rows=n, total=card[0], flags="all False",
        zero_key_rows=zeros, negative_zero_key_rows=int(torch.signbit(keys[keys == 0]).sum()),
        nan_key_rows=0, same_rows_as_cpu=True, launches=card[5], card=smi)
    return {"float_specials": {1: card[5]}}


class Attempts:
    """Counts the attempts distributed_inner_join_auto runs (its calls of
    the unprepared and prepared joins) while active."""

    NAMES = ("distributed_inner_join", "_distributed_inner_join_prepared")

    def __enter__(self):
        from dj_tpu_torch.parallel import dist_join

        self.mod, self.n = dist_join, 0
        self.orig = {name: getattr(dist_join, name) for name in self.NAMES}
        for name, fn in self.orig.items():
            setattr(dist_join, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)
        return counted

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


FACTOR_FIELDS = ("bucket_factor", "join_out_factor", "char_out_factor")


def check_auto(dj, dev, topo, left, lcnt, right, rcnt, build, probe, expected: int, ref, rows: int,
               smi: str) -> dict:
    """Phase 7c: distributed_inner_join_auto. Returns {path: {1: launches}}."""
    from dj_tpu_torch.resilience import ledger

    launch_table = {}

    def auto(*args, **kw):
        reset_launches()
        with Attempts() as a:
            t0 = time.perf_counter()
            res = dj.distributed_inner_join_auto(*args, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        set_flags = [f for f, v in res[2].items() if bool(v.any())]
        if set_flags:
            raise AssertionError(f"7c: flags set after healing: {set_flags}")
        return res, a.n, wall, read_launches()

    # (1) join_out_factor 0.05 overflows (an output of 10M slots for 30M
    # matches); the heal doubles it until the count is exact. (2) Under
    # DJT_LEDGER, a second call with the in-process ledger forgotten
    # replays the file and succeeds on attempt 1. (3) One attempt only:
    # CapacityExhausted.
    tight = dj.JoinConfig(join_out_factor=0.05)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["DJT_LEDGER"] = os.path.join(tmp, "ledger.jsonl")
        try:
            ledger.reset()
            for call in ("first", "second_from_the_ledger_file"):
                res, n, wall, launches = auto(topo, left, lcnt, right, rcnt, [0], [0], tight)
                check_rows(res[0], res[1], build, probe, expected)
                check_same_rows(sorted_rows(res[0], res[1]), ref, f"7c auto {call}")
                if (n == 1) != (call != "first"):
                    raise AssertionError(f"7c auto {call}: {n} attempts")
                launch_table[f"auto_{call}"] = {1: launches}
                log("auto", smoke_phase="7c", call=call, attempts=n,
                    config={f: getattr(tight, f) for f in FACTOR_FIELDS},
                    factors_used={f: getattr(res[3], f) for f in FACTOR_FIELDS}, total=expected,
                    rows_checked=expected, same_rows_as_phase_4=True, wall_ms=wall,
                    launches=launches, ledger_lines=len(open(os.environ["DJT_LEDGER"]).readlines()),
                    card=smi)
                del res
                ledger.reset()
        finally:
            os.environ.pop("DJT_LEDGER")
    ledger.reset()
    try:
        dj.distributed_inner_join_auto(topo, left, lcnt, right, rcnt, [0], [0], tight,
                                       max_attempts=1)
    except dj.CapacityExhausted as e:
        if e.attempts != 1 or not e.flags["join_overflow"]:
            raise AssertionError(f"7c: CapacityExhausted with {e.attempts} attempts, {e.flags}")
        log("auto_exhausted", smoke_phase="7c", max_attempts=1, stage=e.stage,
            attempts=e.attempts, flags=e.flags, factors=e.factors)
    else:
        raise AssertionError("7c: max_attempts=1 did not raise CapacityExhausted")
    torch.cuda.empty_cache()

    # (4) Phase 4d's 4-rank world, bucket_factor 1.0, one probe row in ten
    # on one build key: the hot rank's buckets overflow until the heal
    # grows bucket_factor.
    topo4 = dj.make_topology([dev] * WORLD)
    bk, pk = build.columns[0].data, probe.columns[0].data
    pk2 = pk.clone()
    pk2[::10] = bk[0]
    expected2 = int(torch.isin(pk2, bk).sum())
    skewed = dj.Table((dj.Column(pk2, dj.dtypes.int64), probe.columns[1]))
    l4, lc4 = dj.shard_table(topo4, skewed)
    r4, rc4 = dj.shard_table(topo4, build)
    res, n, wall, launches = auto(topo4, l4, lc4, r4, rc4, [0], [0],
                                  dj.JoinConfig(bucket_factor=1.0))
    out, counts = res[0], res[1]
    if int(counts.sum()) != expected2 or n < 2 or not res[3].bucket_factor > 1.0:
        raise AssertionError(f"7c world: total {int(counts.sum())} (expected {expected2}), "
                             f"{n} attempts, bucket_factor {res[3].bucket_factor}")
    cap = out.capacity // WORLD
    lps = []
    for r, c in enumerate(counts.tolist()):
        k, lp, rp = (col.data[r * cap: r * cap + c] for col in out.columns)
        if not (bool((pk2[lp] == k).all()) and bool((bk[rp] == k).all())):
            raise AssertionError(f"7c world: a row of shard {r} differs from its inputs")
        lps.append(lp)
    s = torch.sort(torch.cat(lps)).values
    if bool((s[1:] == s[:-1]).any()):
        raise AssertionError("7c world: a probe row appears twice")
    launch_table["auto_world4_skewed"] = {1: launches}
    log("auto", smoke_phase="7c", call="world4_skewed", ranks=WORLD, hot_rows=pk2[::10].numel(),
        attempts=n, config={"bucket_factor": 1.0},
        factors_used={f: getattr(res[3], f) for f in FACTOR_FIELDS}, total=expected2,
        counts=counts.tolist(), rows_checked=expected2, wall_ms=wall, launches=launches,
        card=smi)
    del res, out, counts, l4, lc4, r4, rc4, skewed, pk2, lps, s
    torch.cuda.empty_cache()

    # (5) A prepared side probed from the build keys, queried with a
    # probe key below them under the sort and merge tiers: each query
    # re-prepares under the widened range, its rows equal the unprepared
    # join's.
    pk3 = pk.clone()
    pk3[0] = -1
    probe3 = dj.Table((dj.Column(pk3, dj.dtypes.int64), probe.columns[1]))
    l3, lc3 = dj.shard_table(topo, probe3)
    want = dj.distributed_inner_join(topo, l3, lc3, right, rcnt, [0], [0])
    ref3 = sorted_rows(want[0], want[1])
    del want
    for tier in ("sort", "merge"):
        os.environ["DJT_JOIN_MERGE"] = tier
        try:
            prep = dj.prepare_join_side(topo, right, rcnt, [0], left_capacity=rows)
            res, n, wall, launches = auto(topo, l3, lc3, prep, None, [0], None)
        finally:
            os.environ.pop("DJT_JOIN_MERGE")
        what = f"7c prepared auto, tier {tier}"
        check_same_rows(sorted_rows(res[0], res[1]), ref3, what)
        if n != 2 or res[4] is prep or res[4].key_range[0][0] > -1:
            raise AssertionError(f"{what}: {n} attempts, key range {res[4].key_range}")
        if tier == "merge" and launches["merge_sorted_u64"] < 2:
            raise AssertionError(f"{what}: merge_sorted_u64 not launched by each query: {launches}")
        launch_table[f"auto_prepared_reprepare_{tier}"] = {1: launches}
        log("auto", smoke_phase="7c", call="prepared_reprepare", tier=tier, attempts=n,
            old_key_range=prep.key_range, new_key_range=res[4].key_range,
            total=int(res[1].sum()), same_rows_as_unprepared=True, wall_ms=wall,
            launches=launches, card=smi)
        del res, prep
    del l3, lc3, ref3, pk3, probe3
    torch.cuda.empty_cache()
    return launch_table


def ptxas_resources(source: str) -> dict:
    """Registers and spill bytes of each kernel in one CUDA source, from
    the ``-Xptxas -v`` output its build kept: {kernel: {...}}."""
    from dj_tpu_torch.ops import cuda_build

    path = cuda_build.BUILD_DIR / f"{pathlib.Path(source).stem}.ptxas.txt"
    if not path.exists():
        return {"not recorded": str(path)}
    out, kernel = {}, None
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            # The last name of the Itanium nested name _ZN<len><name>...E.
            mangled, i = line.split("'")[1], 3
            while i < len(mangled) and mangled[i].isdigit():
                j = i
                while mangled[j].isdigit():
                    j += 1
                kernel, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
            out[kernel] = {}
        elif kernel and "spill stores" in line:
            n = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[kernel].update(stack_bytes=n[0], spill_store_bytes=n[1], spill_load_bytes=n[2])
        elif kernel and "Used" in line and "registers" in line:
            out[kernel]["registers"] = int(line.split("Used")[1].split()[0])
    return out


def run_probe(name: str, mod, counters=("launches",)) -> dict:
    """A hardware probe's own entry point on the card: its lines are
    logged, and it must print CORRECT and launch each of its kernels
    (one launch counter each). Returns its results with each counter's
    launches in the run."""
    for c in counters:
        setattr(mod, c, 0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = mod.main([])
    lines = buf.getvalue().splitlines()
    counts = {c: getattr(mod, c) for c in counters}
    res.update(counts)
    log("probe", probe=name, lines=lines, **counts)
    if "CORRECT" not in lines or min(counts.values()) < 1:
        raise AssertionError(f"{name}: no CORRECT line or a kernel not launched ({counts}): {lines}")
    return res


def compare_tile_sort(case: str, x, tile: int) -> int:
    """tile_sort against its plain version, every word equal; returns the
    max |kernel - plain| (0, or it raises)."""
    from dj_tpu_torch.hw import probe_sort

    got = probe_sort.tile_sort(x, tile).view(torch.int32)
    want = probe_sort.tile_sort_plain(x, tile).view(torch.int32)
    torch.cuda.synchronize()
    bad = torch.nonzero(got != want).flatten()
    if bad.numel():
        i = int(bad[0])
        raise AssertionError(f"{case}: tile_sort differs at {bad.numel()} of {got.numel()} words, "
                             f"first at {i}: {int(got[i]) & 0xFFFFFFFF:#x} vs {int(want[i]) & 0xFFFFFFFF:#x}")
    log("kernels_vs_plain", case=case, kernel="tile_sort", NT=x.numel() // tile, TILE=tile,
        max_abs_err=0, words_equal=x.numel())
    return 0


def compare_gather(case: str, vals, idx, kernels=("run", "run_cluster")) -> int:
    """Each gather kernel (the L2 gather ``run``, the cluster gather
    ``run_cluster``) against the plain version, every word equal; returns
    the max |kernel - plain| (0, or it raises)."""
    from dj_tpu_torch.hw import probe_gather

    want = probe_gather.run_plain(vals, idx)
    for kernel in kernels:
        got = getattr(probe_gather, kernel)(vals, idx)
        torch.cuda.synchronize()
        bad = torch.nonzero(got != want).flatten()
        if bad.numel():
            i = int(bad[0])
            raise AssertionError(f"{case}: {kernel} differs at {bad.numel()} of {got.numel()} words, "
                                 f"first at {i} (index {int(idx[i])}): {int(got[i])} vs {int(want[i])}")
    n = vals.numel()
    log("kernels_vs_plain", case=case, kernels=list(kernels), N=n, N_mod_4=n % 4,
        N_mod_cluster=n % probe_gather.CLUSTER, idx_offset_mod_16=idx.data_ptr() % 16,
        in_range=int(((idx >= 0) & (idx < n)).sum()),
        negative_wrapped=int(((idx >= -n) & (idx < 0)).sum()),
        outside=int(((idx < -n) | (idx >= n)).sum()), max_abs_err=0, words_equal=n)
    return 0


WORLD = 4  # ranks of phase 4d's world
CHAIN_ROWS = 2_000_000  # rows a side of 6b's chain (4j's chain on a small table)


def check_colocated(what: str, out, counts, odf: int) -> None:
    """Every valid row of shard r has murmur3(key, MAIN_JOIN_SEED) %
    (WORLD * odf) % WORLD == r: its key's partition went to rank r."""
    from dj_tpu_torch.core.table import Column, Table
    from dj_tpu_torch.core import dtypes
    from dj_tpu_torch.ops import hashing
    from dj_tpu_torch.parallel.dist_join import MAIN_JOIN_SEED

    cap = out.capacity // WORLD
    for r, n in enumerate(counts.tolist()):
        keys = out.columns[0].data[r * cap : r * cap + n]
        h = hashing.hash_table(Table((Column(keys, dtypes.int64),)), [0], MAIN_JOIN_SEED)
        if not bool((h % (WORLD * odf) % WORLD == r).all()):
            raise AssertionError(f"{what}: a row on shard {r} hashes to another rank")


def warm_walls(fn, reps: int = 3):
    """(median wall ms, the walls, peak bytes) of ``reps`` calls of fn,
    each ending in a synchronize."""
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        del res
    return statistics.median(runs), runs, torch.cuda.max_memory_allocated()


def world_phases(fn) -> dict:
    """One call of fn with each rank's device time by phase (CUDA events
    on the stream the ranks share), summed over the ranks."""
    from dj_tpu_torch.parallel import spmd

    with spmd.record_phases() as runs:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    del res
    by_rank = runs[-1]
    total: dict = {}
    for phases in by_rank:
        for k, v in phases.items():
            total[k] = total.get(k, 0.0) + v
    busy = sum(total.values())
    return {"wall_ms": wall, "phase_ms": total, "in_phases_ms": busy,
            "outside_phases_ms": wall - busy, "phase_ms_by_rank": by_rank}


def run_world(dj, dev, build, probe, expected: int, ref, rows: int, smi: str):
    """Phase 4d: the main path over a 4-rank world on the one card.
    Returns ({path: {odf: launches}}, the shard digests of the default
    join at odf 1)."""
    from dj_tpu_torch.ops.join import EXPAND_KERNELS, prepared_effective_plan

    topo = dj.make_topology([dev] * WORLD)
    left, lcnt = dj.shard_table(topo, probe)
    right, rcnt = dj.shard_table(topo, build)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    launch_table: dict = {}

    def check(what, res, odf, kernels):
        out, counts, info = res
        torch.cuda.synchronize()
        launches = read_launches()
        set_flags = [k for k, v in info.items() if bool(v.any())]
        if set_flags:
            raise AssertionError(f"{what}: flags set on a shard: {set_flags}")
        if tuple(counts.shape) != (WORLD,) or int(counts.sum()) != expected:
            raise AssertionError(f"{what}: counts {counts.tolist()} do not sum to {expected}")
        check_colocated(what, out, counts, odf)
        flat = dj.unshard_table(out, counts)
        flat_counts = torch.tensor([flat.capacity])
        check_rows(flat, flat_counts, build, probe, expected)
        check_same_rows(sorted_rows(flat, flat_counts), ref, what)
        wrong = {k: launches[k] for k in kernels if launches[k] != WORLD * odf}
        if wrong:
            raise AssertionError(f"{what}: each of {kernels} must launch {WORLD * odf} times "
                                 f"(once a rank and batch): {wrong}")
        return launches, counts.tolist()

    summary: dict = {}
    for odf in (1, 4):
        cfg = dj.JoinConfig(over_decom_factor=odf)

        def join():
            return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)

        what = f"world of {WORLD}, odf={odf}"
        reset_launches()
        res = join()
        launches, counts = check(what, res, odf, ("join_scans", "expand_values"))
        if odf == 1:
            digests = shard_digests(res[0], res[1])
        del res
        launch_table.setdefault("unprepared", {})[odf] = launches
        wall, runs, peak = warm_walls(join)
        summary[f"unprepared_odf{odf}"] = {"wall_ms": wall, "wall_ms_runs": runs, "peak_bytes": peak}
        log("world_path", ranks=WORLD, odf=odf, rows=rows, counts=counts, total=expected,
            flags="all False", rows_checked=expected, colocated=True, same_rows_as_one_rank=True,
            launches=launches, wall_ms=wall, wall_ms_runs=runs, peak_bytes=peak,
            resident_bytes=resident)
        if odf == 1:
            profile_join(join, path="world4_unprepared", odf=odf)
            summary["unprepared_odf1"]["phases"] = world_phases(join)
            log("world_phases", path="unprepared", odf=odf, **summary["unprepared_odf1"]["phases"])
    for mode in MODES:
        os.environ["DJT_JOIN_EXPAND"] = mode
        cfg = dj.JoinConfig()
        reset_launches()
        t0 = time.perf_counter()
        res = dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches, counts = check(f"world of {WORLD}, mode={mode}", res, 1,
                                 ("join_scans", EXPAND_KERNELS[mode]))
        del res
        launch_table.setdefault(f"unprepared_{mode}", {})[1] = launches
        summary[f"{mode}_odf1"] = {"wall_ms_one_run": wall}
        log("world_path", ranks=WORLD, mode=mode, odf=1, counts=counts, total=expected,
            flags="all False", rows_checked=expected, colocated=True, same_rows_as_one_rank=True,
            launches=launches, wall_ms_one_run=wall)
    os.environ.pop("DJT_JOIN_EXPAND")

    cfg = dj.JoinConfig(key_range=(0, 2 * rows))
    prep_runs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(4):  # the first warms up, the next three are timed
        prep = None
        t0 = time.perf_counter()
        prep = dj.prepare_join_side(topo, right, rcnt, [0], cfg, left_capacity=rows)
        torch.cuda.synchronize()
        prep_runs.append((time.perf_counter() - t0) * 1e3)
    summary["prepare_odf1"] = {"wall_ms": statistics.median(prep_runs[1:]), "wall_ms_runs": prep_runs,
                               "peak_bytes": torch.cuda.max_memory_allocated()}
    log("world_prepare", ranks=WORLD, odf=1, **summary["prepare_odf1"],
        resident_rows_per_rank_batch=prep.batches[0][0].shape[0] // WORLD)
    for tier in TIERS:
        os.environ["DJT_JOIN_MERGE"] = tier

        def query():
            return dj.distributed_inner_join(topo, left, lcnt, prep, None, [0], None, cfg)

        reset_launches()
        launches, counts = check(f"world of {WORLD}, prepared tier={tier}", query(), 1,
                                 prepared_effective_plan(tier))
        launch_table.setdefault(f"prepared_{tier}", {})[1] = launches
        wall, runs, peak = warm_walls(query)
        phases = world_phases(query)
        summary[f"prepared_{tier}_odf1"] = {"wall_ms": wall, "wall_ms_runs": runs, "peak_bytes": peak,
                                            "phase_ms": phases["phase_ms"]}
        log("world_path", ranks=WORLD, prepared_tier=tier, odf=1, counts=counts, total=expected,
            flags="all False", rows_checked=expected, colocated=True, same_rows_as_one_rank=True,
            launches=launches, wall_ms=wall, wall_ms_runs=runs, peak_bytes=peak)
        log("world_phases", path=f"prepared_{tier}", odf=1, **phases)
    os.environ.pop("DJT_JOIN_MERGE")
    del prep
    log("world", ranks=WORLD, device=str(dev), rows_per_rank=rows // WORLD, resident_bytes=resident,
        **summary, card=smi, shard_digests_odf1=digests)
    return launch_table, digests


# --- the two-level world and shuffle_on (phases 4e, 4f) ------------------

INTRA = 2  # the intra size of phase 4e's and 4f's two-level world


def key_hash(keys, seed: int):
    """murmur3 of an int64 key column, as the partition hashes it."""
    from dj_tpu_torch.core import dtypes
    from dj_tpu_torch.core.table import Column, Table
    from dj_tpu_torch.ops import hashing

    return hashing.hash_table(Table((Column(keys, dtypes.int64),)), [0], seed)


def check_two_level_placed(what: str, out, counts, odf: int) -> None:
    """Every valid row of shard r of the two-level world sits in its
    key's domain, murmur3(key, INTER_DOMAIN_SEED) % (WORLD / INTRA) ==
    r // INTRA, and on its partition's rank there, murmur3(key,
    MAIN_JOIN_SEED) % (INTRA odf) % INTRA == r % INTRA."""
    from dj_tpu_torch.parallel.dist_join import INTER_DOMAIN_SEED, MAIN_JOIN_SEED

    cap = out.capacity // WORLD
    for r, n in enumerate(counts.tolist()):
        keys = out.columns[0].data[r * cap : r * cap + n]
        inter = key_hash(keys, INTER_DOMAIN_SEED) % (WORLD // INTRA) == r // INTRA
        intra = key_hash(keys, MAIN_JOIN_SEED) % (INTRA * odf) % INTRA == r % INTRA
        if not bool((inter & intra).all()):
            raise AssertionError(f"{what}: a row on shard {r} belongs to another rank")


def pre_shuffle_ms(phases: dict) -> dict:
    """The pre-shuffle's device ms of one {phase: ms}: its own phase (the
    partition over 'inter') and the bucketize, exchange and compact
    marked inside it, summed."""
    return sum(v for k, v in phases.items() if k.startswith("dj_pre_shuffle"))


def check_two_level(dj, what: str, res, odf: int, kernels, build, probe, expected: int, ref,
                    launches_each=None):
    """A join result of the two-level world: every flag False (the
    pre-shuffle's compression counters aside), counts summing to the
    generator's count, each row in its domain and on its rank there,
    every row checked and equal to phase 4's, and each of ``kernels``
    launched ``launches_each`` times (default once a rank and batch).
    Returns (launches, counts)."""
    out, counts, info = res[:3]
    torch.cuda.synchronize()
    launches = read_launches()
    set_flags = [k for k, v in info.items()
                 if not k.startswith("pre_shuffle_comp") and bool(v.any())]
    if set_flags:
        raise AssertionError(f"{what}: flags set on a shard: {set_flags}")
    if tuple(counts.shape) != (WORLD,) or int(counts.sum()) != expected:
        raise AssertionError(f"{what}: counts {counts.tolist()} do not sum to {expected}")
    check_two_level_placed(what, out, counts, odf)
    flat = dj.unshard_table(out, counts)
    flat_counts = torch.tensor([flat.capacity])
    check_rows(flat, flat_counts, build, probe, expected)
    check_same_rows(sorted_rows(flat, flat_counts), ref, what)
    each = WORLD * odf if launches_each is None else launches_each
    wrong = {k: launches[k] for k in kernels if launches[k] != each}
    if wrong:
        raise AssertionError(f"{what}: each of {kernels} must launch {each} times: {wrong}")
    return launches, counts.tolist()


def run_two_level(dj, dev, build, probe, expected: int, ref, rows: int, smi: str):
    """Phase 4e: the main path over phase 4d's 4 ranks factored into 2
    domains of 2 ranks. Returns ({path: {odf: launches}}, the shard
    digests of the default join at odf 1)."""
    from dj_tpu_torch.ops.join import prepared_effective_plan
    from dj_tpu_torch.resilience import ledger

    t_phase = time.perf_counter()
    topo = dj.make_topology([dev] * WORLD, intra_size=INTRA)
    left, lcnt = dj.shard_table(topo, probe)
    right, rcnt = dj.shard_table(topo, build)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    launch_table: dict = {}

    def check(what, res, odf, kernels, launches_each=None):
        return check_two_level(dj, what, res, odf, kernels, build, probe, expected, ref,
                               launches_each)

    summary: dict = {}
    for odf in (1, 4):
        cfg = dj.JoinConfig(over_decom_factor=odf)

        def join():
            return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)

        what = f"two-level world {WORLD // INTRA} x {INTRA}, odf={odf}"
        reset_launches()
        res = join()
        launches, counts = check(what, res, odf, ("join_scans", "expand_values"))
        if odf == 1:
            digests = shard_digests(res[0], res[1])
        del res
        launch_table.setdefault("unprepared", {})[odf] = launches
        wall, runs, peak = warm_walls(join)
        summary[f"unprepared_odf{odf}"] = {"wall_ms": wall, "wall_ms_runs": runs,
                                           "peak_bytes": peak}
        extra = {}
        if odf == 1:
            profile_join(join, path="world4_two_level_unprepared", odf=odf)
            phases = world_phases(join)
            extra = {"pre_shuffle_ms": pre_shuffle_ms(phases["phase_ms"]),
                     "pre_shuffle_ms_by_rank": [pre_shuffle_ms(p)
                                                for p in phases["phase_ms_by_rank"]],
                     "phases": phases}
            summary["unprepared_odf1"]["phases"] = extra
        log("two_level_path", smoke_phase="4e", ranks=WORLD, intra=INTRA, odf=odf, rows=rows,
            counts=counts, total=expected, flags="all False", rows_checked=expected,
            placed=True, same_rows_as_one_rank=True, launches=launches, wall_ms=wall,
            wall_ms_runs=runs, peak_bytes=peak, resident_bytes=resident, **extra)

    from dj_tpu_torch.ops.join import EXPAND_KERNELS

    for mode in MODES:
        os.environ["DJT_JOIN_EXPAND"] = mode
        cfg = dj.JoinConfig()
        reset_launches()
        t0 = time.perf_counter()
        res = dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches, counts = check(f"two-level world, mode={mode}", res, 1,
                                 ("join_scans", EXPAND_KERNELS[mode]))
        del res
        launch_table.setdefault(f"unprepared_{mode}", {})[1] = launches
        summary[f"{mode}_odf1"] = {"wall_ms_one_run": wall}
        log("two_level_path", smoke_phase="4e", ranks=WORLD, intra=INTRA, mode=mode, odf=1,
            counts=counts, total=expected, flags="all False", rows_checked=expected,
            placed=True, same_rows_as_one_rank=True, launches=launches, wall_ms_one_run=wall)
    os.environ.pop("DJT_JOIN_EXPAND")

    # distributed_inner_join_auto from pre_shuffle_out_factor 0.5 (and
    # bucket_factor 1.0, so that the heal, which grows both, lands near
    # the defaults' sizes at growth 2.5): pre_shuffle_overflow heals.
    ledger.reset()
    tight = dj.JoinConfig(pre_shuffle_out_factor=0.5, bucket_factor=1.0)
    reset_launches()
    with Attempts() as a:
        t0 = time.perf_counter()
        res = dj.distributed_inner_join_auto(topo, left, lcnt, right, rcnt, [0], [0], tight,
                                             growth=2.5)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches, counts = check("4e auto", res, 1, ("join_scans", "expand_values"),
                             launches_each=WORLD * a.n)
    if a.n < 2 or not res[3].pre_shuffle_out_factor > 0.5:
        raise AssertionError(f"4e auto: {a.n} attempts, pre_shuffle_out_factor "
                             f"{res[3].pre_shuffle_out_factor}: pre_shuffle_overflow did not heal")
    factors = ("pre_shuffle_out_factor",) + FACTOR_FIELDS
    launch_table["auto_pre_shuffle"] = {1: launches}
    log("two_level_auto", smoke_phase="4e", attempts=a.n, growth=2.5,
        config={f: getattr(tight, f) for f in factors},
        factors_used={f: getattr(res[3], f) for f in factors}, counts=counts, total=expected,
        flags="all False", rows_checked=expected, wall_ms=wall, launches=launches, card=smi)
    del res
    ledger.reset()  # the two-level world shares the flat world's signature

    cfg = dj.JoinConfig(key_range=(0, 2 * rows))
    prep_runs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(4):  # the first warms up, the next three are timed
        prep = None
        t0 = time.perf_counter()
        prep = dj.prepare_join_side(topo, right, rcnt, [0], cfg, left_capacity=rows)
        torch.cuda.synchronize()
        prep_runs.append((time.perf_counter() - t0) * 1e3)
    summary["prepare_odf1"] = {"wall_ms": statistics.median(prep_runs[1:]),
                               "wall_ms_runs": prep_runs,
                               "peak_bytes": torch.cuda.max_memory_allocated()}
    log("two_level_prepare", smoke_phase="4e", ranks=WORLD, intra=INTRA, odf=1,
        **summary["prepare_odf1"], resident_rows_per_rank_batch=prep.batches[0][0].shape[0] // WORLD)
    for tier in TIERS:
        os.environ["DJT_JOIN_MERGE"] = tier

        def query():
            return dj.distributed_inner_join(topo, left, lcnt, prep, None, [0], None, cfg)

        reset_launches()
        launches, counts = check(f"two-level world, prepared tier={tier}", query(), 1,
                                 prepared_effective_plan(tier))
        launch_table.setdefault(f"prepared_{tier}", {})[1] = launches
        wall, runs, peak = warm_walls(query)
        summary[f"prepared_{tier}_odf1"] = {"wall_ms": wall, "wall_ms_runs": runs,
                                            "peak_bytes": peak}
        log("two_level_path", smoke_phase="4e", ranks=WORLD, intra=INTRA, prepared_tier=tier,
            odf=1, counts=counts, total=expected, flags="all False", rows_checked=expected,
            placed=True, same_rows_as_one_rank=True, launches=launches, wall_ms=wall,
            wall_ms_runs=runs, peak_bytes=peak)
    os.environ.pop("DJT_JOIN_MERGE")
    del prep, left, right
    log("two_level", smoke_phase="4e", ranks=WORLD, intra=INTRA, device=str(dev),
        rows_per_rank=rows // WORLD, resident_bytes=resident, **summary, card=smi,
        shard_digests_odf1=digests, one_card="no link is crossed: the second exchange's "
        "cost only", seconds=time.perf_counter() - t_phase)
    return launch_table, digests


# GPU-BDB web_clickstreams' four int64 columns (benchmarks/gpubdb_shuffle_on.py)
# and the ranges each is drawn from.
CLICK_COLUMNS = (("wcs_user_sk", 0, 10_000_000), ("wcs_item_sk", 0, 400_000),
                 ("wcs_click_date_sk", 36_890, 38_716), ("wcs_click_time_sk", 0, 86_400))


def clickstream_table(dj, dev, rows: int, seed: int, hot: bool = False):
    """Phase 4f's table: ``rows`` rows of the four web_clickstreams
    columns drawn from ``seed`` on the device (the repo has no parquet of
    them); with ``hot``, one row in ten on one wcs_user_sk."""
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    cols = [torch.randint(lo, hi, (rows,), generator=gen, device=dev)
            for _, lo, hi in CLICK_COLUMNS]
    if hot:
        cols[0][::10] = 4242
    return dj.Table(tuple(dj.Column(c, dj.dtypes.int64) for c in cols))


def row_mix(cols) -> torch.Tensor:
    """One mixed int64 word per row of int64 columns (shard_digest's)."""
    h = torch.zeros_like(cols[0])
    for j, x in enumerate(cols):
        h = (h ^ x) * MIX[j % 3]
        h = h ^ (h >> 29)
    return h


def check_shuffled(what: str, res, table, placed) -> list:
    """A shuffle_on result over the 4 ranks: no overflow, every row on
    the shard ``placed(keys, r)`` names, and the row multiset of
    ``table`` (sorted row words equal). Returns the counts."""
    out, counts, overflow = res[:3]
    if bool(overflow.any()):
        raise AssertionError(f"{what}: overflow on shards {overflow.tolist()}")
    if int(counts.sum()) != table.capacity:
        raise AssertionError(f"{what}: counts {counts.tolist()} != {table.capacity} rows")
    cap = out.capacity // WORLD
    mixes = []
    for r, n in enumerate(counts.tolist()):
        cols = [c.data[r * cap : r * cap + n] for c in out.columns]
        if not bool(placed(cols[0], r).all()):
            raise AssertionError(f"{what}: a row on shard {r} hashes to another shard")
        mixes.append(row_mix(cols))
    got = torch.sort(torch.cat(mixes)).values
    if not torch.equal(got, torch.sort(row_mix([c.data for c in table.columns])).values):
        raise AssertionError(f"{what}: the row multiset changed")
    return counts.tolist()


def run_shuffle_on(dj, dev, rows: int, seed: int, smi: str) -> list:
    """Phase 4f: shuffle_on of a web_clickstreams-shaped table of ``rows``
    rows on column 0: over phase 4d's world, per axis over 4e's two-level
    world, and shuffle_on_auto on a skewed copy. Returns the two-level
    result's shard digests (6b holds its processes to them)."""
    from dj_tpu_torch.ops.hashing import DEFAULT_HASH_SEED
    from dj_tpu_torch.parallel import shuffle
    from dj_tpu_torch.parallel.dist_join import INTER_DOMAIN_SEED
    from dj_tpu_torch.resilience import ledger

    t_phase = time.perf_counter()
    table = clickstream_table(dj, dev, rows, seed)
    flat = dj.make_topology([dev] * WORLD)
    t, c = dj.shard_table(flat, table)

    def run_flat():
        return dj.shuffle_on(flat, t, c, [0], with_split_overflow=True)

    counts = check_shuffled("4f flat", run_flat(), table,
                            lambda k, r: key_hash(k, DEFAULT_HASH_SEED) % WORLD == r)
    wall, runs, peak = warm_walls(run_flat)
    log("shuffle_on", smoke_phase="4f", topology="flat", ranks=WORLD, rows=rows,
        columns=[n for n, _, _ in CLICK_COLUMNS], counts=counts, overflow="all False",
        placed=True, rows_conserved=True, wall_ms=wall, wall_ms_runs=runs, peak_bytes=peak,
        card=smi)
    del t, c

    two = dj.make_topology([dev] * WORLD, intra_size=INTRA)
    t2, c2 = dj.shard_table(two, table)

    def run_two():
        a = dj.shuffle_on(two, t2, c2, [0], group=two.group("inter"), seed=INTER_DOMAIN_SEED)
        if bool(a[2].any()):
            raise AssertionError(f"4f inter: overflow on shards {a[2].tolist()}")
        return dj.shuffle_on(two, a[0], a[1], [0], group=two.group("intra"))

    res = run_two()
    counts = check_shuffled(
        "4f two-level", res, table,
        lambda k, r: ((key_hash(k, INTER_DOMAIN_SEED) % (WORLD // INTRA) == r // INTRA)
                      & (key_hash(k, DEFAULT_HASH_SEED) % INTRA == r % INTRA)))
    digests = shard_digests(res[0], res[1])
    del res
    wall, runs, peak = warm_walls(run_two)
    log("shuffle_on", smoke_phase="4f", topology=f"{WORLD // INTRA} x {INTRA}",
        axes=["inter (seed 87654321)", "intra"], ranks=WORLD, rows=rows, counts=counts,
        overflow="all False", placed=True, rows_conserved=True, wall_ms=wall,
        wall_ms_runs=runs, peak_bytes=peak, shard_digests=digests, card=smi)
    del t2, c2, table

    hot = clickstream_table(dj, dev, rows, seed, hot=True)
    th, ch = dj.shard_table(flat, hot)
    ledger.reset()
    calls = []
    orig = shuffle.shuffle_on
    shuffle.shuffle_on = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        t0 = time.perf_counter()
        res = dj.shuffle_on_auto(flat, th, ch, [0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        shuffle.shuffle_on = orig
    counts = check_shuffled("4f auto", res, hot,
                            lambda k, r: key_hash(k, DEFAULT_HASH_SEED) % WORLD == r)
    if len(calls) < 2 or not res[3] > 1.2:
        raise AssertionError(f"4f auto: {len(calls)} attempts, bucket_factor {res[3]}")
    log("shuffle_on_auto", smoke_phase="4f", ranks=WORLD, rows=rows, hot_rows=rows // 10,
        attempts=len(calls), factors_from=[1.2, 1.2], bucket_factor=res[3], out_factor=res[4],
        counts=counts, overflow="all False", placed=True, rows_conserved=True, wall_ms=wall,
        card=smi)
    ledger.reset()
    del res, th, ch, hot
    log("shuffle_on_phase", smoke_phase="4f", seconds=time.perf_counter() - t_phase,
        data="columns drawn from the seed on the card: the repo has no parquet of "
             "web_clickstreams and the card's machine no pyarrow")
    return digests


# --- the cascaded wire codec (phases 4g, 4e and 4f compressed) -------------

CASCADES = tuple((r, d, bp) for r in (0, 1) for d in (0, 1) for bp in (True, False))


def codec_inputs(dev, itemsize: int, rows: int, seed: int) -> list:
    """Phase 4g's two [4, rows] inputs of one itemsize, drawn from the seed
    on the device, one pattern a bucket (tests/test_compression.py:48-60
    and more): constant, strided, small range, runs; full range, the
    width's extremes (+-2^63 at 8 bytes), a sorted walk up from the
    minimum, zeros after an iota."""
    from dj_tpu_torch.compress.cascaded import _INT_OF_SIZE

    dtype = _INT_OF_SIZE[itemsize]
    info = torch.iinfo(dtype)
    g = torch.Generator(device=dev).manual_seed(seed + 40 + itemsize)

    def ri(lo, hi, n=rows):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int64)

    iota = torch.arange(rows, device=dev, dtype=torch.int64)
    a = [torch.full((rows,), int(ri(info.min, info.max, 1)), device=dev, dtype=torch.int64),
         iota * 3 + 1000, ri(0, 16),
         torch.repeat_interleave(ri(0, 5, -(-rows // 64)), 64)[:rows]]
    b = [ri(info.min, info.max),
         torch.where(ri(0, 2) == 0, info.min, info.max),
         torch.cumsum(ri(0, 4), 0) + info.min + 5,
         torch.where(iota < rows // 2, iota, 0)]
    return [torch.stack(x).to(dtype) for x in (a, b)]


def check_codec(dev, n: int, rows: int, seed: int, smi: str, time_rows: int) -> dict:
    """Phase 4g. Part 1: compress_buckets / decompress_buckets on the card
    for each of the 8 cascades and itemsizes 1, 2, 4 and 8, on
    codec_inputs' [n, rows] buckets with counts below rows, at the
    capacity of wire_factor 1.0 (the cascades without bitpack overflow
    on the wide patterns); words, totals, overflow bits and decodes
    equal element for element to the same calls on the CPU, and each
    bucket that did not overflow decodes to its input's prefix. The RLE
    decodes launch expand_ranks (counted from 0 around the card's
    calls). Part 2: the auto-selected cascade of each of 4f's columns
    at 4f's flat bucket shape ([4, time_rows] int64 buckets, half full),
    compress and decompress timed apart beside their byte bound."""
    from dj_tpu_torch.compress import cascaded as cz
    from dj_tpu_torch.ops import expand

    t_phase = time.perf_counter()
    counts = torch.tensor([rows, rows - 1, rows // 2 + 17, 3], device=dev)[:n]
    cpu = torch.device("cpu")
    counts_cpu = counts.to(cpu)
    keep = torch.arange(rows, device=dev)[None, :] < counts[:, None]
    launches = overflowed = compared = 0

    def same_as_cpu(what, x_cpu, itemsize, opts, cap, card):
        # The CPU's calls (the path the tests hold to dj_tpu) on the same
        # inputs, in a worker thread while the card goes on.
        pw, pt, po = cz.compress_buckets(x_cpu, itemsize, opts, cap, counts_cpu)
        pdec = cz.decompress_buckets(pw, itemsize, opts, rows, x_cpu.dtype)
        for name, got, want in zip(("words", "totals", "overflow", "decode"), card,
                                   (pw, pt, po, pdec)):
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: {name} differ from the CPU's")

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        pending = []
        for itemsize in (1, 2, 4, 8):
            cap = cz.compressed_capacity_words(rows * itemsize, 1.0)
            for x in codec_inputs(dev, itemsize, rows, seed):
                x = x[:n]
                x_cpu = x.to(cpu)
                for cascade in CASCADES:
                    opts = cz.CascadedOptions(*cascade)
                    what = f"codec itemsize={itemsize} cascade={cascade}"
                    reset_launches()
                    words, total, ovf = cz.compress_buckets(x, itemsize, opts, cap, counts)
                    dec = cz.decompress_buckets(words, itemsize, opts, rows, x.dtype)
                    torch.cuda.synchronize()
                    launches += expand.ranks_launches
                    if cascade[0] and expand.ranks_launches != 1:
                        raise AssertionError(f"{what}: the RLE decode launched expand_ranks "
                                             f"{expand.ranks_launches} times, not 1")
                    for p in range(n):
                        if bool(ovf[p]):
                            overflowed += 1
                        elif not torch.equal(dec[p], torch.where(keep[p], x[p], 0)):
                            raise AssertionError(f"{what}: bucket {p} does not decode to its "
                                                 f"input")
                    card = tuple(t.to(cpu) for t in (words, total, ovf, dec))
                    pending.append(pool.submit(same_as_cpu, what, x_cpu, itemsize, opts, cap,
                                               card))
                    compared += 1
        for f in pending:
            f.result()
    log("codec", smoke_phase="4g", part=1, buckets=n, rows=rows, itemsizes=[1, 2, 4, 8],
        cascades=len(CASCADES), inputs=compared, counts=counts.tolist(),
        overflowed_buckets=overflowed, equal_to_cpu=True, decodes_checked=True,
        expand_ranks_launches=launches, card=smi, seconds=time.perf_counter() - t_phase)

    # Part 2: 4f's columns at 4f's flat bucket shape.
    count = time_rows // 2
    timing = {}
    for name, lo, hi in CLICK_COLUMNS:
        g = torch.Generator(device=dev).manual_seed(seed + 7)
        x = torch.randint(lo, hi, (4, time_rows), generator=g, device=dev)
        opts, wf = cz.select_cascaded_options(cz.selector_sample(x[:, :count].reshape(-1)))
        cap = cz.compressed_capacity_words(time_rows * 8, wf)
        c = torch.full((4,), count, device=dev)
        words, total, ovf = cz.compress_buckets(x, 8, opts, cap, c)
        if bool(ovf.any()) or not torch.equal(
                cz.decompress_buckets(words, 8, opts, time_rows, torch.int64)[:, :count],
                x[:, :count]):
            raise AssertionError(f"codec {name}: the timed cascade does not round-trip")
        comp_ms = cuda_ms(lambda: cz.compress_buckets(x, 8, opts, cap, c), 3)
        dec_ms = cuda_ms(lambda: cz.decompress_buckets(words, 8, opts, time_rows, torch.int64), 3)
        comp_bytes = 4 * count * 8 + words.numel() * 8
        dec_bytes = int(total.sum()) * 8 + x.numel() * 8
        timing[name] = {
            "cascade": astuple(opts), "wire_factor": wf, "compress_ms": comp_ms,
            "decompress_ms": dec_ms, "compress_bytes": comp_bytes, "decompress_bytes": dec_bytes,
            "compress_bound_ms": comp_bytes / HBM_BYTES_PER_S * 1e3,
            "decompress_bound_ms": dec_bytes / HBM_BYTES_PER_S * 1e3,
            "raw_over_actual": 4 * count * 8 / (int(total.sum()) * 8)}
        del x, words
    log("codec_time", smoke_phase="4g", part=2, buckets=4, bucket_rows=time_rows, count=count,
        columns=timing, bytes="compress: the valid rows read, every wire word written; "
        "decompress: the stream's words read, every bucket row written", card=smi,
        seconds=time.perf_counter() - t_phase)
    return {"cascades": len(CASCADES), "max_abs_err": 0, "expand_ranks_launches": launches,
            "timing": timing}


def astuple(opts) -> tuple:
    return (opts.num_rles, opts.num_deltas, opts.use_bp)


def comp_sums(info: dict, prefix: str) -> dict:
    """The three compression counters summed over the shards, with
    raw/actual and wire/raw."""
    from dj_tpu_torch.parallel.shuffle import STAT_KEYS

    sums = {k: float(info[prefix + k].double().sum()) for k in STAT_KEYS}
    raw, wire, actual = (sums[k] for k in STAT_KEYS)
    if not (raw > 0 and actual > 0 and actual <= wire):
        raise AssertionError(f"compression counters {sums}: nothing compressed, or a "
                             f"stream larger than its wire")
    return {**sums, "raw_over_actual": raw / actual, "wire_over_raw": wire / raw}


def options_summary(opts) -> list:
    """[cascade, wire_factor] of each column's options (a string column's
    sizes child), or "none"."""
    out = []
    for o in opts:
        o = o.children[0] if o.children else o
        out.append([list(astuple(o.cascaded)), o.wire_factor] if o.method == "cascaded"
                   else "none")
    return out


def run_two_level_compressed(dj, dev, build, probe, expected: int, ref, rows: int,
                             smi: str) -> dict:
    """Phase 4e compressed: 4e's two-level world with each side's auto
    options (broadcast_compression_options, as the reference's driver
    agrees on them) on the pre-shuffle, as
    benchmarks/distributed_join.py --compression does: the join at odf 1
    (vmeta) checked as in 4e, its counters, walls, the pre-shuffle's
    device ms and the peak; distributed_inner_join_auto from 4e's tight
    start (pre_shuffle_out_factor 0.5, bucket_factor 1.0, growth 2.5);
    prepare_join_side with right_compression and one sort-tier query
    with left_compression. Returns {path: {1: launches}}."""
    from dj_tpu_torch.resilience import ledger

    t_phase = time.perf_counter()
    topo = dj.make_topology([dev] * WORLD, intra_size=INTRA)
    left, lcnt = dj.shard_table(topo, probe)
    right, rcnt = dj.shard_table(topo, build)
    t0 = time.perf_counter()
    lopts = dj.broadcast_compression_options(dj.generate_auto_select_compression_options(left))
    ropts = dj.broadcast_compression_options(dj.generate_auto_select_compression_options(right))
    select_ms = (time.perf_counter() - t0) * 1e3
    cfg = dj.JoinConfig(left_compression=lopts, right_compression=ropts)

    def join():
        return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)

    launch_table: dict = {}
    reset_launches()
    res = join()
    launches, counts = check_two_level(dj, "4e compressed", res, 1,
                                       ("join_scans", "expand_values"), build, probe,
                                       expected, ref)
    sums = comp_sums(res[2], "pre_shuffle_")
    del res
    launch_table["compressed"] = {1: launches}
    wall, runs, peak = warm_walls(join)
    phases = world_phases(join)
    log("two_level_compressed", smoke_phase="4e", ranks=WORLD, intra=INTRA, odf=1, rows=rows,
        options={"probe": options_summary(lopts), "build": options_summary(ropts)},
        select_ms=select_ms, counts=counts, total=expected, flags="all False",
        rows_checked=expected, placed=True, same_rows_as_one_rank=True, launches=launches,
        wall_ms=wall, wall_ms_runs=runs, peak_bytes=peak,
        pre_shuffle_ms=pre_shuffle_ms(phases["phase_ms"]),
        pre_shuffle_ms_by_rank=[pre_shuffle_ms(p) for p in phases["phase_ms_by_rank"]],
        phase_ms=phases["phase_ms"], comp=sums, card=smi)

    ledger.reset()
    tight = dj.JoinConfig(pre_shuffle_out_factor=0.5, bucket_factor=1.0, left_compression=lopts,
                          right_compression=ropts)
    reset_launches()
    with Attempts() as a:
        t0 = time.perf_counter()
        res = dj.distributed_inner_join_auto(topo, left, lcnt, right, rcnt, [0], [0], tight,
                                             growth=2.5)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches, counts = check_two_level(dj, "4e compressed auto", res, 1,
                                       ("join_scans", "expand_values"), build, probe, expected,
                                       ref, launches_each=WORLD * a.n)
    if a.n < 2 or not res[3].pre_shuffle_out_factor > 0.5:
        raise AssertionError(f"4e compressed auto: {a.n} attempts, pre_shuffle_out_factor "
                             f"{res[3].pre_shuffle_out_factor}: pre_shuffle_overflow did not heal")
    factors = ("pre_shuffle_out_factor",) + FACTOR_FIELDS
    launch_table["compressed_auto"] = {1: launches}
    log("two_level_compressed_auto", smoke_phase="4e", attempts=a.n, growth=2.5,
        config={f: getattr(tight, f) for f in factors},
        factors_used={f: getattr(res[3], f) for f in factors}, counts=counts, total=expected,
        flags="all False", rows_checked=expected, wall_ms=wall, launches=launches,
        comp=comp_sums(res[2], "pre_shuffle_"), card=smi)
    del res
    ledger.reset()

    pcfg = dj.JoinConfig(key_range=(0, 2 * rows), left_compression=lopts,
                         right_compression=ropts)
    t0 = time.perf_counter()
    prep = dj.prepare_join_side(topo, right, rcnt, [0], pcfg, left_capacity=rows)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    os.environ["DJT_JOIN_MERGE"] = "sort"
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = dj.distributed_inner_join(topo, left, lcnt, prep, None, [0], None, pcfg)
        torch.cuda.synchronize()
        query_ms = (time.perf_counter() - t0) * 1e3
        launches, counts = check_two_level(dj, "4e compressed prepared", res, 1,
                                           ("join_scans", "expand_values"), build, probe,
                                           expected, ref)
    finally:
        os.environ.pop("DJT_JOIN_MERGE")
    launch_table["compressed_prepared_sort"] = {1: launches}
    log("two_level_compressed_prepared", smoke_phase="4e", prepared_tier="sort", odf=1,
        prepare_ms_one_run=prep_ms, query_ms_one_run=query_ms, counts=counts, total=expected,
        flags="all False", rows_checked=expected, launches=launches,
        comp=comp_sums(res[2], "pre_shuffle_"), card=smi,
        seconds=time.perf_counter() - t_phase)
    del res, prep, left, right
    return launch_table


def with_wire_factor(opts, wf: float):
    """The options with every cascaded column's wire_factor set to wf."""
    import dataclasses

    return tuple(dataclasses.replace(o, wire_factor=wf) if o.method == "cascaded" else o
                 for o in opts)


def run_shuffle_on_compressed(dj, dev, rows: int, seed: int, smi: str,
                              two_level_digests: list) -> None:
    """Phase 4f compressed: 4f's table shuffled with its auto options, as
    benchmarks/gpubdb_shuffle_on.py --compression does: flat and per
    axis, each shard's rows equal to the uncompressed shuffle's (shard
    digests; per axis 4f's own), the counters, walls and peak; then a
    wire_factor of 0.2 on every column of the skewed copy: at factors
    1.8 / 2.4 (where the rows fit, the uncompressed shuffle says) the
    wire sets the bucket bit, and shuffle_on_auto from 1.2 / 1.2 heals
    it."""
    from dj_tpu_torch.ops.hashing import DEFAULT_HASH_SEED
    from dj_tpu_torch.parallel import shuffle
    from dj_tpu_torch.parallel.dist_join import INTER_DOMAIN_SEED
    from dj_tpu_torch.resilience import ledger

    t_phase = time.perf_counter()
    table = clickstream_table(dj, dev, rows, seed)
    flat = dj.make_topology([dev] * WORLD)
    t, c = dj.shard_table(flat, table)
    opts = dj.broadcast_compression_options(dj.generate_auto_select_compression_options(t))
    want = shard_digests(*dj.shuffle_on(flat, t, c, [0])[:2])

    def run_flat():
        return dj.shuffle_on(flat, t, c, [0], compression=opts, with_stats=True)

    res = run_flat()
    counts = check_shuffled("4f compressed flat", res, table,
                            lambda k, r: key_hash(k, DEFAULT_HASH_SEED) % WORLD == r)
    if shard_digests(res[0], res[1]) != want:
        raise AssertionError("4f compressed flat: the shards differ from the uncompressed ones")
    sums = comp_sums(res[3], "")
    del res
    wall, runs, peak = warm_walls(run_flat)
    log("shuffle_on_compressed", smoke_phase="4f", topology="flat", ranks=WORLD, rows=rows,
        options=options_summary(opts), counts=counts, overflow="all False",
        same_shards_as_uncompressed=True, wall_ms=wall, wall_ms_runs=runs, peak_bytes=peak,
        comp=sums, card=smi)
    del t, c

    two = dj.make_topology([dev] * WORLD, intra_size=INTRA)
    t2, c2 = dj.shard_table(two, table)

    def run_two():
        a = dj.shuffle_on(two, t2, c2, [0], group=two.group("inter"), seed=INTER_DOMAIN_SEED,
                          compression=opts, with_stats=True)
        if bool(a[2].any()):
            raise AssertionError(f"4f compressed inter: overflow on shards {a[2].tolist()}")
        b = dj.shuffle_on(two, a[0], a[1], [0], group=two.group("intra"), compression=opts,
                          with_stats=True)
        return b, a[3]

    res, inter_stats = run_two()
    counts = check_shuffled(
        "4f compressed two-level", res, table,
        lambda k, r: ((key_hash(k, INTER_DOMAIN_SEED) % (WORLD // INTRA) == r // INTRA)
                      & (key_hash(k, DEFAULT_HASH_SEED) % INTRA == r % INTRA)))
    if shard_digests(res[0], res[1]) != two_level_digests:
        raise AssertionError("4f compressed two-level: the shards differ from 4f's")
    sums = {"inter": comp_sums(inter_stats, ""), "intra": comp_sums(res[3], "")}
    del res, inter_stats
    wall, runs, peak = warm_walls(run_two)
    log("shuffle_on_compressed", smoke_phase="4f", topology=f"{WORLD // INTRA} x {INTRA}",
        axes=["inter (seed 87654321)", "intra"], ranks=WORLD, rows=rows, counts=counts,
        overflow="all False", same_shards_as_uncompressed=True, wall_ms=wall,
        wall_ms_runs=runs, peak_bytes=peak, comp=sums, card=smi)
    del t2, c2, table

    hot = clickstream_table(dj, dev, rows, seed, hot=True)
    th, ch = dj.shard_table(flat, hot)
    tight = with_wire_factor(
        dj.broadcast_compression_options(dj.generate_auto_select_compression_options(th)), 0.2)
    raw = dj.shuffle_on(flat, th, ch, [0], bucket_factor=1.8, out_factor=2.4,
                        with_split_overflow=True)
    wire = dj.shuffle_on(flat, th, ch, [0], bucket_factor=1.8, out_factor=2.4,
                         compression=tight, with_split_overflow=True)
    if bool(raw[2].any()) or not bool(wire[3]["bucket"].any()) or bool(wire[3]["out"].any()):
        raise AssertionError(f"4f compressed: at 1.8 / 2.4 the rows must fit "
                             f"({raw[2].tolist()}) and the 0.2 wire set the bucket bit alone "
                             f"({ {k: v.tolist() for k, v in wire[3].items()} })")
    wire_bits = wire[3]["bucket"].tolist()
    del raw, wire
    ledger.reset()
    calls = []
    orig = shuffle.shuffle_on
    shuffle.shuffle_on = lambda *a, **k: calls.append(
        (k["bucket_factor"], k["out_factor"])) or orig(*a, **k)
    try:
        t0 = time.perf_counter()
        res = dj.shuffle_on_auto(flat, th, ch, [0], compression=tight, with_stats=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        shuffle.shuffle_on = orig
    counts = check_shuffled("4f compressed auto", res, hot,
                            lambda k, r: key_hash(k, DEFAULT_HASH_SEED) % WORLD == r)
    if len(calls) < 2 or not res[3] > 1.8:
        raise AssertionError(f"4f compressed auto: attempts {calls}, bucket_factor {res[3]}")
    log("shuffle_on_compressed_auto", smoke_phase="4f", ranks=WORLD, rows=rows,
        hot_rows=rows // 10, wire_factor=0.2, wire_bit_at_1_8=wire_bits, attempts=len(calls),
        factors_by_attempt=calls, bucket_factor=res[3], out_factor=res[4], counts=counts,
        overflow="all False", placed=True, rows_conserved=True, wall_ms=wall,
        comp=comp_sums(res[5], ""), card=smi, seconds=time.perf_counter() - t_phase)
    ledger.reset()
    del res, th, ch, hot


# --- the join's plan knobs (phase 4h) -------------------------------------

def run_knobs(dj, topo, left, lcnt, right, rcnt, build, probe, expected: int, ref, walls: dict,
              smi: str) -> dict:
    """Phase 4h: phase 4's join at odf 1 under DJT_JOIN_RANGE_PROBE=0,
    checked as in 4 with the default join's rows and launches. Returns
    {path: {odf: launches}}."""
    t_phase = time.perf_counter()
    odf = 1
    cfg = dj.JoinConfig(over_decom_factor=odf)

    def join():
        return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)

    what = f"4h range_probe_0 odf={odf}"
    os.environ["DJT_JOIN_RANGE_PROBE"] = "0"
    try:
        reset_launches()
        out, counts, info = join()
        torch.cuda.synchronize()
        launches = read_launches()
        set_flags = [k for k, v in info.items() if bool(v.any())]
        if set_flags:
            raise AssertionError(f"{what}: flags set: {set_flags}")
        check_rows(out, counts, build, probe, expected)
        check_same_rows(sorted_rows(out, counts), ref, what)
        del out, counts, info
        if launches["join_scans"] != odf or launches["expand_values"] != odf:
            raise AssertionError(f"{what}: join_scans and expand_values must launch {odf} "
                                 f"times: {launches}")
        wall, runs, peak = warm_walls(join)
    finally:
        os.environ.pop("DJT_JOIN_RANGE_PROBE")
    log("knob", smoke_phase="4h", knob="range_probe_0", env={"DJT_JOIN_RANGE_PROBE": "0"},
        odf=odf, total=expected, flags="all False", rows_checked=expected,
        same_rows_as_default=True, launches=launches, wall_ms=wall, wall_ms_runs=runs,
        default_wall_ms=walls[odf], peak_bytes=peak, card=smi,
        seconds=time.perf_counter() - t_phase)
    return {"knob_range_probe_0": {odf: launches}}


# --- the skew-adaptive plan tiers (phases 4i and 5e) ----------------------

# 4i(ii): probe rows on one build key, drawn at random with this share
# (at even positions only, the salt peer pos % replicas would use half the
# peers of an even fan-out)
HOT_PROBE_SHARE = 0.5
HOT_BUILD_SHARE = (2, 5)  # 5e: 2 of every 5 build rows on one key
SALTED_SKEW_TIERS = ("merge", "probe")  # 5e(ii)'s salted queries (no sort tier)


class Collectives:
    """Counts the in-process transport's collectives issued while active,
    by kind."""

    NAMES = ("all_to_all_start", "all_gather", "all_reduce", "shift_start")

    def __enter__(self):
        from dj_tpu_torch.parallel.communicator import InProcessTransport

        self.cls, self.counts = InProcessTransport, dict.fromkeys(self.NAMES, 0)
        self.orig = {name: getattr(InProcessTransport, name) for name in self.NAMES}
        for name, fn in self.orig.items():
            setattr(InProcessTransport, name, self._counted(name, fn))
        return self

    def _counted(self, name, fn):
        def counted(transport, *a, **k):
            self.counts[name] += 1
            return fn(transport, *a, **k)
        return counted

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.cls, name, fn)


@contextlib.contextmanager
def env_set(**kv):
    """The DJT_* variables ``kv`` set inside the block, restored after."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def salt_rule(counts, n: int, odf: int, threshold: float = 2.0, topk: int = 3):
    """dj_tpu's salting rule (plan_adapt.decide at its default knobs),
    re-derived here from the gathered [w, n odf] partition counts: per
    batch the destination rows; a destination among the batch's topk is
    heavy when it alone reaches ``threshold`` times the batch's mean;
    the fan-out is ceil(worst ratio) clamped to [2, n]. Returns (salt
    set, replicas, worst ratio)."""
    import math

    import numpy as np

    counts = np.asarray(counts)
    heavy, worst = [], 1.0
    for b in range(odf):
        rows = counts[:, b * n:(b + 1) * n].sum(axis=0)
        mean = float(rows.mean())
        if mean <= 0:
            continue
        worst = max(worst, int(rows.max()) / mean)
        top = sorted(range(n), key=lambda d: -int(rows[d]))[:topk]
        heavy += [b * n + d for d in top if rows[d] >= threshold * mean]
    return tuple(sorted(set(heavy))), max(2, min(n, math.ceil(worst))), worst


def key_matches(build_keys, probe_keys) -> int:
    """The join's row count: per probe row, the build rows of its key."""
    s = torch.sort(build_keys).values
    lo = torch.searchsorted(s, probe_keys)
    hi = torch.searchsorted(s, probe_keys, right=True)
    return int((hi - lo).sum())


def pair_words(out, counts, build, probe, expected: int, what: str):
    """Every output row (k, lp, rp) with probe_key[lp] == k and
    build_key[rp] == k, each (lp, rp) pair once, ``expected`` rows in
    all (build keys may repeat). Returns the sorted pair words lp << 32
    | rp, which hold a result's row multiset."""
    from dj_tpu_torch.parallel.api import unshard_table

    flat = out if counts.shape[0] == 1 else unshard_table(out, counts)
    n = int(counts.sum())
    if n != expected:
        raise AssertionError(f"{what}: {n} rows, expected {expected}")
    k, lp, rp = (c.data[:n] for c in flat.columns)
    if not bool((probe.columns[0].data[lp] == k).all()):
        raise AssertionError(f"{what}: a row's probe key differs from its key column")
    if not bool((build.columns[0].data[rp] == k).all()):
        raise AssertionError(f"{what}: a row's build key differs from its key column")
    words = torch.sort((lp << 32) | rp).values
    if n > 1 and bool((words[1:] == words[:-1]).any()):
        raise AssertionError(f"{what}: a (probe row, build row) pair appears twice")
    return words


def check_on_probe_shard(what: str, out, counts, shard_rows: int) -> None:
    """Every row on shard r joins a probe row of rank r's block: the
    broadcast plan joins each rank's own left shard where it lies."""
    cap = out.capacity // counts.shape[0]
    for r, n in enumerate(counts.tolist()):
        lp = out.columns[1].data[r * cap: r * cap + n]
        if n and not bool(((lp >= r * shard_rows) & (lp < (r + 1) * shard_rows)).all()):
            raise AssertionError(f"{what}: a row on shard {r} joins another rank's probe row")


def flags_false(what: str, info: dict) -> None:
    set_flags = [k for k, v in info.items() if k != "touched" and bool(v.any())]
    if set_flags:
        raise AssertionError(f"{what}: flags set: {set_flags}")


def run_plan_tiers(dj, dev, build, probe, expected: int, ref, rows: int, smi: str,
                   two_level_digests: list) -> tuple[dict, list]:
    """Phase 4i: the unprepared plan tiers in 4d's 4-rank world under
    DJT_PLAN_ADAPT=1. (i) The broadcast plan by fit at odf 1 and 4; (ii)
    the salted plan at odf 1 and 4 under DJT_BROADCAST_BYTES=0 on a
    probe side with a random half of its rows on one build key, beside
    the shuffle plan's heal on the same tables; (iii) a replayed decision takes no
    probe, and 4e's two-level world stays on shuffle. Returns ({path:
    {odf: launches}} of the world, the broadcast plan's shard digests at
    odf 1)."""
    from dj_tpu_torch.parallel import dist_join as dist
    from dj_tpu_torch.resilience import ledger

    t_phase = time.perf_counter()
    topo = dj.make_topology([dev] * WORLD)
    left, lcnt = dj.shard_table(topo, probe)
    right, rcnt = dj.shard_table(topo, build)
    shard_rows = probe.capacity // WORLD
    table: dict = {}
    ledger.reset()

    # (i) the broadcast plan: no partition, no all-to-all.
    with env_set(DJT_PLAN_ADAPT="1"):
        for odf in (1, 4):
            cfg = dj.JoinConfig(over_decom_factor=odf)
            what = f"4i(i) broadcast odf={odf}"
            d = dist._resolve_plan_decision(topo, left, lcnt, right, rcnt, (0,), (0,), cfg)
            if (d.tier, d.source) != ("broadcast", "fit"):
                raise AssertionError(f"{what}: decision {d}")

            def join():
                return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)

            reset_launches()
            with Collectives() as coll:
                out, counts, info = join()
                torch.cuda.synchronize()
            launches = read_launches()
            flags_false(what, info)
            if coll.counts["all_to_all_start"] or coll.counts["shift_start"]:
                raise AssertionError(f"{what}: the join issued an all-to-all: {coll.counts}")
            if int(counts.sum()) != expected:
                raise AssertionError(f"{what}: {int(counts.sum())} rows, expected {expected}")
            check_on_probe_shard(what, out, counts, shard_rows)
            flat = dj.unshard_table(out, counts)
            flat_counts = torch.tensor([flat.capacity])
            check_rows(flat, flat_counts, build, probe, expected)
            check_same_rows(sorted_rows(flat, flat_counts), ref, what)
            if odf == 1:
                digests = shard_digests(out, counts)
            del out, flat, info
            wrong = {k: launches[k] for k in ("join_scans", "expand_values")
                     if launches[k] != WORLD}
            if wrong:
                raise AssertionError(f"{what}: each kernel must launch {WORLD} times: {wrong}")
            table.setdefault("plan_broadcast", {})[odf] = launches
            wall, runs, peak = warm_walls(join)
            phases = world_phases(join)
            log("plan_tier", smoke_phase="4i", case="(i)", tier=d.tier, source=d.source, odf=odf,
                ranks=WORLD, rows=rows, counts=counts.tolist(), total=expected,
                flags="all False", rows_checked=expected, same_rows_as_one_rank=True,
                rows_on_their_probe_shard=True, collectives=coll.counts, launches=launches,
                wall_ms=wall, wall_ms_runs=runs, peak_bytes=peak, phases=phases, card=smi)
            del counts

    # (ii) the salted plan on a probe side with half its rows on one key.
    keys = probe.columns[0].data.clone()
    g = torch.Generator(device=keys.device).manual_seed(14)
    hot_rows = torch.rand(keys.numel(), generator=g, device=keys.device) < HOT_PROBE_SHARE
    keys[hot_rows] = build.columns[0].data[7]
    n_hot = int(hot_rows.sum())
    del hot_rows
    hot = dj.Table((dj.Column(keys, dj.dtypes.int64), probe.columns[1]))
    hot_expected = key_matches(build.columns[0].data, keys)
    del keys
    hl, hlc = dj.shard_table(topo, hot)
    salted_cases = {}
    for odf in (1, 4):
        cfg = dj.JoinConfig(over_decom_factor=odf)
        what = f"4i(ii) odf={odf}"

        def auto(c=cfg, **kw):
            return dj.distributed_inner_join_auto(topo, hl, hlc, right, rcnt, [0], [0], c, **kw)

        # The skewed table has the plain one's signature: forget (i)'s
        # decision and the healed factors, or they replay.
        ledger.reset()
        if odf == 1:
            with Attempts() as a:
                out, counts, info, used = auto()
                torch.cuda.synchronize()
            flags_false(f"{what} shuffle plan", info)
            flat = dj.unshard_table(out, counts)
            flat_counts = torch.tensor([flat.capacity])
            check_rows(flat, flat_counts, build, hot, hot_expected)
            want = sorted_rows(flat, flat_counts)  # the rows at every odf
            del out, counts, info, flat
            shuffle = {"attempts": a.n, **{f: getattr(used, f) for f in FACTOR_FIELDS}}
            shuffle["wall_ms"], shuffle["wall_ms_runs"], shuffle["peak_bytes"] = warm_walls(
                lambda: dj.distributed_inner_join(topo, hl, hlc, right, rcnt, [0], [0], used))
        else:
            # At odf 4 the hot bucket (about 13.3M rows a source) needs
            # bucket_factor 16, whose buckets and output capacities do not
            # fit the card's 80 GB beside the four ranks' tables: the heal
            # is stopped at 4, where it must still overflow.
            with Attempts() as a:
                try:
                    auto(max_attempts=2)
                except dj.CapacityExhausted as e:
                    shuffle = {"attempts": a.n, "capacity_exhausted": dict(e.factors),
                               "flags": sorted(k for k, v in e.flags.items() if v)}
                else:
                    raise AssertionError(f"{what}: the shuffle plan fit at bucket_factor 4")
            torch.cuda.empty_cache()
        ledger.reset()
        with env_set(DJT_PLAN_ADAPT="1", DJT_BROADCAST_BYTES="0"):
            mat = dist._partition_probe_counts(topo, hl, hlc, (0,), odf)
            salt, replicas, worst = salt_rule(mat, WORLD, odf)
            d = dist._resolve_plan_decision(topo, hl, hlc, right, rcnt, (0,), (0,), cfg)
            if (d.tier, d.salt, d.replicas) != ("salted", salt, replicas):
                raise AssertionError(f"{what}: decision {d}, the rule gives {salt} x {replicas}")
            reset_launches()
            with Attempts() as a:
                out, counts, info, s_used = auto()
                torch.cuda.synchronize()
            launches = read_launches()
            flags_false(what, info)
            flat = dj.unshard_table(out, counts)
            flat_counts = torch.tensor([flat.capacity])
            check_rows(flat, flat_counts, build, hot, hot_expected)
            check_same_rows(sorted_rows(flat, flat_counts), want, what)
            del out, info, flat
            wrong = {k: launches[k] for k in ("join_scans", "expand_values")
                     if launches[k] != WORLD * odf * a.n}
            if wrong:
                raise AssertionError(f"{what}: each kernel must launch {WORLD * odf} times an "
                                     f"attempt: {wrong}")
            table.setdefault("plan_salted", {})[odf] = launches

            def join(c=s_used):
                return dj.distributed_inner_join(topo, hl, hlc, right, rcnt, [0], [0], c)

            wall, runs, peak = warm_walls(join)
            phases = world_phases(join)
        salted_cases[odf] = (cfg, d)
        log("plan_tier", smoke_phase="4i", case="(ii)", tier=d.tier, source=d.source, odf=odf,
            ranks=WORLD, rows=rows, hot_probe_rows=n_hot, salt=list(d.salt),
            replicas=d.replicas, ratio=d.ratio, rule_salt=list(salt), rule_replicas=replicas,
            rule_worst_ratio=worst, counts=counts.tolist(), total=hot_expected,
            flags="all False", rows_checked=hot_expected, same_rows_as_shuffle_plan=True,
            salted_attempts=a.n, salted_bucket_factor_healed=s_used.bucket_factor > 2.0,
            salted_factors={f: getattr(s_used, f) for f in FACTOR_FIELDS},
            shuffle_plan=shuffle, launches=launches, wall_ms=wall, wall_ms_runs=runs,
            peak_bytes=peak, phases=phases, card=smi)
        del counts

    # (iii) a replayed decision takes no probe; a two-level world stays on
    # the shuffle plan.
    probes = []
    real = dist._partition_probe_counts
    dist._partition_probe_counts = lambda *a, **k: probes.append(1) or real(*a, **k)
    try:
        with env_set(DJT_PLAN_ADAPT="1", DJT_BROADCAST_BYTES="0"):
            cfg, first = salted_cases[4]  # the last decided: each odf reset the ledger
            d = dist._resolve_plan_decision(topo, hl, hlc, right, rcnt, (0,), (0,), cfg)
            cfg = dj.JoinConfig()
            if (d.source, d.tier, d.salt, d.replicas) != ("ledger", first.tier, first.salt,
                                                          first.replicas) or probes:
                raise AssertionError(f"4i(iii): the replay gave {d} after {len(probes)} probes")
            topo2 = dj.make_topology([dev] * WORLD, intra_size=INTRA)
            l2, lc2 = dj.shard_table(topo2, probe)
            r2, rc2 = dj.shard_table(topo2, build)
            d2 = dist._resolve_plan_decision(topo2, l2, lc2, r2, rc2, (0,), (0,), cfg)
            out, counts, info = dj.distributed_inner_join(topo2, l2, lc2, r2, rc2, [0], [0], cfg)
            torch.cuda.synchronize()
            flags_false("4i(iii) two-level", info)
            got = shard_digests(out, counts)
            if d2.tier != "shuffle" or probes or got != two_level_digests:
                raise AssertionError(f"4i(iii): the two-level world planned {d2} after "
                                     f"{len(probes)} probes, digests {got} vs 4e's")
            del out, counts, info, l2, lc2, r2, rc2
    finally:
        dist._partition_probe_counts = real
    log("plan_tier", smoke_phase="4i", case="(iii)", replay_source=d.source, replay_probes=0,
        two_level_tier=d2.tier, two_level_source=d2.source, two_level_digests_equal_4e=True,
        card=smi)
    ledger.reset()
    del hl, hlc, hot, left, right, want
    torch.cuda.empty_cache()
    log("plan_tier_phase", smoke_phase="4i", seconds=time.perf_counter() - t_phase)
    return table, digests


def run_prepared_tiers(dj, dev, gen, topo1, left1, lcnt1, build, probe, expected: int, ref,
                       rows: int, smi: str) -> dict:
    """Phase 5e: the prepared tiers in 4d's 4-rank world on phase 5's
    build table. (i) DJT_PREPARED_TIER=broadcast and auto (which must
    pick broadcast) at odf 1, a query under each merge tier issuing no
    collective; (ii) DJT_PREPARED_TIER=salted on a build side with two
    fifths of its rows on one key, held to the shuffle-prepared side's
    rows; (iii) a 1% append to the broadcast side re-prepares on its
    tier, its queries equal to the unprepared join of the combined
    table. Returns {path: {odf: launches}} of the world."""
    from dj_tpu_torch.ops.join import prepared_effective_plan
    from dj_tpu_torch.parallel import dist_join as dist
    from dj_tpu_torch.resilience import ledger

    t_phase = time.perf_counter()
    topo = dj.make_topology([dev] * WORLD)
    left, lcnt = dj.shard_table(topo, probe)
    right, rcnt = dj.shard_table(topo, build)
    cfg = dj.JoinConfig(key_range=(0, 2 * rows))
    table: dict = {}
    ledger.reset()

    def query_checked(what, prep, tier, l_side, check):
        """One query under merge tier ``tier``: no collective, flags
        False, its kernels launched once a rank, rows by ``check``."""
        os.environ["DJT_JOIN_MERGE"] = tier
        reset_launches()
        with Collectives() as coll:
            out, counts, info = dj.distributed_inner_join(topo, *l_side, prep, None, [0], None,
                                                          cfg)
            torch.cuda.synchronize()
        launches = read_launches()
        flags_false(what, info)
        check(out, counts)
        del out, info
        wrong = {k: launches[k] for k in prepared_effective_plan(tier) if launches[k] != WORLD}
        if wrong:
            raise AssertionError(f"{what}: each kernel must launch {WORLD} times: {wrong}")
        return launches, coll.counts, counts.tolist()

    def same_as(want_rows, base, probe_t, total):
        def check(out, counts):
            flat = dj.unshard_table(out, counts)
            flat_counts = torch.tensor([flat.capacity])
            check_rows(flat, flat_counts, base, probe_t, total)
            check_same_rows(sorted_rows(flat, flat_counts), want_rows, "5e")
        return check

    # (i) broadcast and auto: one replicated batch a rank, queries with
    # no collective.
    for knob in ("broadcast", "auto"):
        ledger.reset()
        with env_set(DJT_PREPARED_TIER=knob):
            prep_wall, prep_runs, prep_peak = warm_walls(
                lambda: dj.prepare_join_side(topo, right, rcnt, [0], cfg, left_capacity=rows))
            prep = dj.prepare_join_side(topo, right, rcnt, [0], cfg, left_capacity=rows)
        if prep.tier != "broadcast" or len(prep.batches) != 1:
            raise AssertionError(f"5e(i) {knob}: tier {prep.tier}, {len(prep.batches)} batches")
        queries = {}
        for tier in (TIERS if knob == "broadcast" else ("sort",)):
            what = f"5e(i) {knob} tier={tier}"
            launches, coll, counts = query_checked(what, prep, tier, (left, lcnt),
                                                   same_as(ref, build, probe, expected))
            if any(coll.values()):
                raise AssertionError(f"{what}: the query issued collectives: {coll}")
            table[f"prepared_broadcast_{tier}" if knob == "broadcast"
                  else "prepared_auto_sort"] = {1: launches}

            def query():
                return dj.distributed_inner_join(topo, left, lcnt, prep, None, [0], None, cfg)

            wall, runs, peak = warm_walls(query)
            queries[tier] = {"wall_ms": wall, "wall_ms_runs": runs, "peak_bytes": peak,
                             "counts": counts, "launches": launches, "collectives": coll,
                             "phase_ms": world_phases(query)["phase_ms"]}
        os.environ.pop("DJT_JOIN_MERGE")
        log("prepared_tier", smoke_phase="5e", case="(i)", knob=knob, tier=prep.tier, odf=1,
            ranks=WORLD, resident_rows_per_rank=prep.batches[0][0].shape[0] // WORLD,
            tag_bits=prep.plan.tag_bits, prepare_wall_ms=prep_wall,
            prepare_wall_ms_runs=prep_runs, prepare_peak_bytes=prep_peak, total=expected,
            flags="all False", rows_checked=expected, same_rows_as_one_rank=True,
            queries=queries, card=smi)
        if knob == "broadcast":
            bprep = prep
        del prep

    # (iii) a 1% append to the broadcast side: it re-prepares on its tier.
    n_app = max(1, rows // 100)
    keys = absent_keys(gen, dev, build.columns[0].data, 2 * rows, n_app)
    app = appended_table(dj, keys, build.capacity)
    combined = dj.concatenate([build, app]).with_count(None)
    want_total = expected + appended_matches(probe, keys)
    cright, crcnt = dj.shard_table(topo1, combined)
    out, counts, info = dj.distributed_inner_join(topo1, left1, lcnt1, cright, crcnt, [0], [0])
    torch.cuda.synchronize()
    flags_false("5e(iii) unprepared combined", info)
    check_rows(out, counts, combined, probe, want_total)
    ref_c = sorted_rows(out, counts)
    del out, counts, info, cright, crcnt, keys
    a_side = dj.shard_table(topo, app)
    t0 = time.perf_counter()
    new, info = dj.append_to_prepared(topo, bprep, *a_side)
    torch.cuda.synchronize()
    append_ms = (time.perf_counter() - t0) * 1e3
    flags_false("5e(iii) append", info)
    if new.tier != "broadcast" or info["touched"] != (0,):
        raise AssertionError(f"5e(iii): tier {new.tier}, touched {info['touched']}")
    del bprep
    appended = {}
    for tier in TIERS:
        what = f"5e(iii) appended tier={tier}"
        launches, coll, counts = query_checked(what, new, tier, (left, lcnt),
                                               same_as(ref_c, combined, probe, want_total))
        table[f"prepared_broadcast_append_{tier}"] = {1: launches}
        appended[tier] = {"launches": launches, "collectives": coll}
    os.environ.pop("DJT_JOIN_MERGE")
    log("prepared_tier", smoke_phase="5e", case="(iii)", tier=new.tier, appended_rows=n_app,
        touched=list(info["touched"]), append_ms=append_ms, total=want_total, flags="all False",
        rows_checked=want_total, same_rows_as_unprepared_combined=True, queries=appended,
        card=smi)
    del new, info, a_side, app, combined, ref_c
    torch.cuda.empty_cache()

    # (ii) salted: two fifths of the build rows on one key, which exactly
    # one probe row carries. Both prepares heal bucket_factor to 4, so the
    # salted one exchanges three [4, 25M] windows a rank: fused into one
    # collective, the four ranks' copies of them ran out of the card's
    # 80 GB, so this case moves one buffer a collective (fuse_columns
    # False, dj_tpu's unfused exchange), the shuffle-prepared side too.
    del right, rcnt
    torch.cuda.empty_cache()
    cfg = dj.JoinConfig(key_range=(0, 2 * rows), fuse_columns=False)
    pk, bk = probe.columns[0].data, build.columns[0].data
    uniq, cnt = torch.unique_consecutive(torch.sort(pk).values, return_counts=True)
    sb = torch.sort(bk).values
    inb = sb[torch.searchsorted(sb, uniq).clamp_max_(sb.numel() - 1)] == uniq
    hot_key = uniq[(cnt == 1) & inb][0]
    del uniq, cnt, sb, inb
    every, of = HOT_BUILD_SHARE
    hb = bk.clone()
    hb[torch.arange(rows, device=dev) % of < every] = hot_key
    skewed = dj.Table((dj.Column(hb, dj.dtypes.int64), build.columns[1]))
    s_expected = key_matches(hb, pk)
    del hb
    sr, src = dj.shard_table(topo, skewed)
    sides = {}
    for knob in ("shuffle", "salted"):
        ledger.reset()
        torch.cuda.reset_peak_memory_stats()
        with env_set(DJT_PREPARED_TIER=knob):
            t0 = time.perf_counter()
            prep = dj.prepare_join_side(topo, sr, src, [0], cfg, left_capacity=rows)
            torch.cuda.synchronize()
            prep_ms = (time.perf_counter() - t0) * 1e3
        prep_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if prep.tier != knob:
            raise AssertionError(f"5e(ii): DJT_PREPARED_TIER={knob} prepared {prep.tier}")
        rule = None
        if knob == "salted":
            mat = dist._partition_probe_counts(topo, sr, src, (0,), 1)
            rule = salt_rule(mat, WORLD, 1)
            if (prep.salt, prep.salt_replicas) != rule[:2]:
                raise AssertionError(f"5e(ii): salt {prep.salt} x {prep.salt_replicas}, the "
                                     f"rule gives {rule}")
        queries = {}
        # The salted side holds 3 x 4 x 25M resident slots a rank; a sort-tier
        # query sorts them with its 100M probe slots (400M words a rank),
        # which did not fit beside the four ranks' resident runs on one card.
        for tier in (SALTED_SKEW_TIERS if knob == "salted" else ("sort",)):
            os.environ["DJT_JOIN_MERGE"] = tier
            what = f"5e(ii) {knob} tier={tier}"
            reset_launches()
            with Attempts() as a:
                out, counts, info, used, _ = dj.distributed_inner_join_auto(
                    topo, left, lcnt, prep, None, [0], None, prep.config)
                torch.cuda.synchronize()
            launches = read_launches()
            flags_false(what, info)
            words = pair_words(out, counts, skewed, probe, s_expected, what)
            if "words" in sides and not torch.equal(words, sides["words"]):
                raise AssertionError(f"{what}: rows differ from the shuffle-prepared side's")
            sides.setdefault("words", words)
            del out, info, words
            missing = [k for k in prepared_effective_plan(tier) if launches[k] < WORLD]
            if missing:
                raise AssertionError(f"{what}: kernels not launched by every rank: {missing}")
            table[f"prepared_{knob}_skewed_{tier}"] = {1: launches}
            t0 = time.perf_counter()
            res = dj.distributed_inner_join(topo, left, lcnt, prep, None, [0], None, used)
            torch.cuda.synchronize()
            queries[tier] = {"attempts": a.n, "wall_ms_one_warm_run":
                             (time.perf_counter() - t0) * 1e3, "counts": counts.tolist(),
                             "factors": {f: getattr(used, f) for f in FACTOR_FIELDS},
                             "launches": launches}
            del res, counts
        os.environ.pop("DJT_JOIN_MERGE")
        log("prepared_tier", smoke_phase="5e", case="(ii)", tier=prep.tier, odf=1, ranks=WORLD,
            hot_build_rows=rows * every // of, hot_probe_rows=1, salt=list(prep.salt),
            replicas=prep.salt_replicas, rule=list(rule) if rule else None,
            prepare_ms=prep_ms, prepare_peak_bytes=prep_peak,
            prepare_factors={f: getattr(prep.config, f) for f in FACTOR_FIELDS},
            resident_rows_per_rank=prep.batches[0][0].shape[0] // WORLD,
            tag_bits=prep.plan.tag_bits, total=s_expected, flags="all False",
            rows_checked=s_expected, same_rows_as_shuffle_prepared=knob == "salted",
            queries=queries, query_peak_bytes=torch.cuda.max_memory_allocated(),
            **({"sort_tier": "not run: 400M words a rank to sort beside four resident runs "
                             "of 300M slots exceed one card's 80 GB"} if knob == "salted" else {}),
            card=smi)
        del prep
        torch.cuda.empty_cache()
    ledger.reset()
    del sides, sr, src, skewed, left
    torch.cuda.empty_cache()
    log("prepared_tier_phase", smoke_phase="5e", seconds=time.perf_counter() - t_phase)
    return table


# --- the probe tier's expansions (phase 5d) -------------------------------

PROBE_EXPANDS = ("segment", "hist", "pallas")


def run_probe_expand(dj, topo, left, lcnt, prep, cfg, odf: int, build, probe, expected: int, ref,
                     smi: str) -> dict:
    """Phase 5d, one odf: phase 5's probe-tier query under each
    DJT_PROBE_EXPAND mode, checked as in 5, each launching its mode's
    kernel (expand_ranks, or expand_values under "pallas") once a batch.
    Returns {path: {odf: launches}}."""
    from dj_tpu_torch.ops.join import prepared_effective_plan

    launch_table: dict = {}
    os.environ["DJT_JOIN_MERGE"] = "probe"
    try:
        for mode in PROBE_EXPANDS:
            os.environ["DJT_PROBE_EXPAND"] = mode

            def query():
                return dj.distributed_inner_join(topo, left, lcnt, prep, None, [0], None, cfg)

            what = f"5d probe tier, DJT_PROBE_EXPAND={mode} odf={odf}"
            reset_launches()
            out, counts, info = query()
            torch.cuda.synchronize()
            launches = read_launches()
            set_flags = [k for k, v in info.items() if bool(v.any())]
            if set_flags:
                raise AssertionError(f"{what}: flags set: {set_flags}")
            check_rows(out, counts, build, probe, expected)
            check_same_rows(sorted_rows(out, counts), ref, what)
            del out, counts, info
            (kernel,) = prepared_effective_plan("probe", mode)
            if launches[kernel] != odf:
                raise AssertionError(f"{what}: {kernel} must launch once a batch: {launches}")
            launch_table[f"prepared_probe_{mode}"] = {odf: launches}
            wall, runs, peak = warm_walls(query)
            log("probe_expand", smoke_phase="5d", mode=mode, odf=odf, total=expected,
                flags="all False", rows_checked=expected, same_rows_as_unprepared=True,
                kernel=kernel, launches=launches, wall_ms=wall, wall_ms_runs=runs,
                peak_bytes=peak, card=smi)
    finally:
        os.environ.pop("DJT_PROBE_EXPAND", None)
        os.environ.pop("DJT_JOIN_MERGE")
    return launch_table


def compare_probe_values(case: str, cnt, n_out: int, timing: bool = False,
                         need_global_windows: bool = False):
    """expand_values as the probe tier calls it under "pallas" (stag =
    arange(L), run_start = 0, so its outputs are (src, t)) against its
    plain version on the int32 ``cnt`` of L probe rows: every slot below
    the total equal, and every src in [0, L) (where csum wraps past 2^31
    no slot is specified, and only that is held). Returns the max |kernel
    - plain| and, with ``timing``, times."""
    from dj_tpu_torch.ops import expand

    L = cnt.numel()
    csum = torch.cumsum(cnt, 0, dtype=torch.int64).to(torch.int32)
    stag = torch.arange(L, dtype=torch.int32, device=cnt.device)
    zero = torch.zeros(L, dtype=torch.int32, device=cnt.device)
    src, t = expand.expand_values(csum, cnt, stag, zero, n_out)
    wsrc, wt = expand.expand_values_plain(csum, cnt, stag, zero, n_out)
    torch.cuda.synchronize()
    total = int(cnt.sum(dtype=torch.int64))
    wrapped = total > 2**31 - 1
    if n_out and not bool(((src >= 0) & (src < L)).all()):
        raise AssertionError(f"{case}: expand_values gave a row outside [0, {L})")
    k = 0 if wrapped else min(total, n_out)
    err = max_abs_diff(((src[:k], wsrc[:k]), (t[:k], wt[:k])))
    if err:
        for name, g, w in (("src", src[:k], wsrc[:k]), ("t", t[:k], wt[:k])):
            if bool((g != w).any()):
                bad = int(torch.nonzero(g != w)[0])
                raise AssertionError(f"{case}: expand_values {name} differs first at {bad}: "
                                     f"{int(g[bad])} vs {int(w[bad])} (max |err| {err})")
    del src, t, wsrc, wt
    widest, n_global = (0, 0) if wrapped else block_windows(csum, n_out, total)
    if need_global_windows and not n_global:
        raise AssertionError(f"{case}: no expand_values window is wider than {expand.WIN} "
                             f"(widest {widest}); the global-memory search was not exercised")
    log("kernels_vs_plain", case=case, kernel="expand_values", path="probe tier", L=L,
        n_out=n_out, total=total, max_abs_err=err, slots_compared=k, rows_in_range=True,
        widest_window=widest, blocks_over_win=n_global,
        **({"note": "csum wrapped past 2^31: no slot specified, rows held in range"}
           if wrapped else {}))
    if not timing:
        return err
    j = torch.arange(n_out, dtype=torch.int32, device=cnt.device)
    times = {
        "ms": cuda_ms(lambda: expand.expand_values(csum, cnt, stag, zero, n_out), 5),
        "plain_ms": cuda_ms(lambda: expand.expand_values_plain(csum, cnt, stag, zero, n_out), 2),
        "library_ms": cuda_ms(lambda: torch.searchsorted(csum, j, right=True, out_int32=True), 5),
        "L": L, "n_out": n_out,
    }
    return err, times


def probe_values_edge_cases(gen, dev, sk: int) -> list:
    """expand_values on the probe tier's three edge cases: one probe row
    with ``sk`` matches amid sparse ones (windows past the shared stage),
    a batch with no match, and a csum that wraps past 2^31."""
    L = 5 * sk
    hot = (torch.rand(L, generator=gen, device=dev) < 1e-4).to(torch.int32)
    hot[L // 2] = sk
    errs = [compare_probe_values("probe_tier_hot_key", hot, int(hot.sum()) + 3,
                                 need_global_windows=True)]
    errs.append(compare_probe_values("probe_tier_no_match",
                                     torch.zeros(3 * sk, dtype=torch.int32, device=dev), sk))
    wrap = torch.randint(0, 3, (sk,), generator=gen, device=dev, dtype=torch.int32)
    wrap[sk // 3] = wrap[2 * sk // 3] = 1_500_000_000
    errs.append(compare_probe_values("probe_tier_csum_wraps", wrap, sk))
    return errs


# --- appends to a prepared side (phase 5c) ---------------------------------

def absent_keys(gen, dev, present, hi: int, n: int, batch0_of: int = 0):
    """n distinct int64 keys in [0, hi] that ``present`` lacks, in a
    random order, drawn from ``gen`` on the card; with ``batch0_of`` = m,
    only keys in partition 0 of m (murmur3, the join's seed)."""
    from dj_tpu_torch.core import dtypes
    from dj_tpu_torch.core.table import Column, Table
    from dj_tpu_torch.ops.partition import partition_ids
    from dj_tpu_torch.parallel.dist_join import MAIN_JOIN_SEED

    have = torch.sort(present).values
    draw = 4 * n * max(1, batch0_of)
    cand = torch.unique(torch.randint(0, hi + 1, (draw,), generator=gen, device=dev))
    at = torch.searchsorted(have, cand).clamp_max_(have.numel() - 1)
    cand = cand[have[at] != cand]
    if batch0_of:
        pid = partition_ids(Table((Column(cand, dtypes.int64),)), [0], batch0_of, MAIN_JOIN_SEED)
        cand = cand[pid == 0]
    if cand.numel() < n:
        raise AssertionError(f"absent_keys: {cand.numel()} candidates for {n} keys")
    return cand[torch.randperm(cand.numel(), generator=gen, device=dev)[:n]]


def appended_table(dj, keys, first_row: int):
    """(key, row id) rows, the ids continuing the build table's."""
    rows = torch.arange(first_row, first_row + keys.numel(), device=keys.device)
    return dj.Table((dj.Column(keys, dj.dtypes.int64), dj.Column(rows, dj.dtypes.int64)))


def appended_matches(probe, keys) -> int:
    """Probe rows whose key is one of ``keys`` (distinct)."""
    s = torch.sort(keys).values
    pk = probe.columns[0].data
    at = torch.searchsorted(s, pk).clamp_max_(s.numel() - 1)
    return int((s[at] == pk).sum())


def run_appends(dj, dev, gen, topo, left, lcnt, right, rcnt, build, probe, expected: int,
                rows: int, smi: str) -> tuple[dict, dict]:
    """Phase 5c: appends to phase 5's build table prepared at odf 4. (i)
    1% more rows, keys the build side lacks, then a query under each
    tier equal to the unprepared join of the combined table; (ii) rows
    of batch 0 only; (iii) an append at odf 1, where the batch has no
    slack; (iv) (i) in 4d's 4-rank world; (v) a two-level topology
    refused. Returns ({path: {odf: launches}} of one rank, the same of
    the 4-rank world)."""
    from dj_tpu_torch.ops.join import prepared_effective_plan

    t_phase = time.perf_counter()
    launch_table: dict = {}
    world_table: dict = {}
    cfg = dj.JoinConfig(over_decom_factor=4, key_range=(0, 2 * rows))
    n_app = max(1, rows // 100)
    keys = absent_keys(gen, dev, build.columns[0].data, 2 * rows, n_app)
    app = appended_table(dj, keys, build.capacity)
    combined = dj.concatenate([build, app]).with_count(None)
    want_total = expected + appended_matches(probe, keys)
    del keys
    cright, crcnt = dj.shard_table(topo, combined)
    out, counts, info = dj.distributed_inner_join(topo, left, lcnt, cright, crcnt, [0], [0])
    torch.cuda.synchronize()
    if any(bool(v.any()) for v in info.values()):
        raise AssertionError("5c: the unprepared join of the combined table set a flag")
    check_rows(out, counts, combined, probe, want_total)
    ref = sorted_rows(out, counts)
    del out, counts, info, cright, crcnt
    torch.cuda.empty_cache()

    def check_append(what, side, info, touched):
        set_flags = [k for k, v in info.items() if k != "touched" and bool(v.any())]
        if set_flags:
            raise AssertionError(f"{what}: flags set: {set_flags}")
        if info["touched"] != touched:
            raise AssertionError(f"{what}: touched {info['touched']}, expected {touched}")

    def check_query(what, res, w, kernels):
        out, counts, info = res
        torch.cuda.synchronize()
        launches = read_launches()
        set_flags = [k for k, v in info.items() if bool(v.any())]
        if set_flags:
            raise AssertionError(f"{what}: flags set: {set_flags}")
        if int(counts.sum()) != want_total:
            raise AssertionError(f"{what}: {int(counts.sum())} rows, expected {want_total}")
        flat = dj.unshard_table(out, counts) if w > 1 else out
        flat_counts = torch.tensor([int(counts.sum())])
        check_rows(flat, flat_counts, combined, probe, want_total)
        check_same_rows(sorted_rows(flat, flat_counts), ref, what)
        wrong = {k: launches[k] for k in kernels if launches[k] != w * 4}
        if wrong:
            raise AssertionError(f"{what}: each of {kernels} must launch {w * 4} times: {wrong}")
        return launches

    for w in (1, WORLD):
        summary: dict = {}
        t = topo if w == 1 else dj.make_topology([dev] * WORLD)
        l_side, r_side = ((left, lcnt), (right, rcnt)) if w == 1 else (
            dj.shard_table(t, probe), dj.shard_table(t, build))
        a_side = dj.shard_table(t, app)
        prep = dj.prepare_join_side(t, *r_side, [0], cfg, left_capacity=rows)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        new, info = dj.append_to_prepared(t, prep, *a_side)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        check_append(f"5c(i) world {w}", new, info, (0, 1, 2, 3))
        wall, runs, _ = warm_walls(lambda: dj.append_to_prepared(t, prep, *a_side))
        fresh, fresh_runs, fresh_peak = warm_walls(
            lambda: dj.prepare_join_side(t, new.right, new.right_counts, [0], cfg,
                                         left_capacity=rows), reps=2)
        del prep
        for tier in TIERS:
            os.environ["DJT_JOIN_MERGE"] = tier

            def query():
                return dj.distributed_inner_join(t, *l_side, new, None, [0], None, cfg)

            reset_launches()
            launches = check_query(f"5c(i) world {w} tier={tier}", query(), w,
                                   prepared_effective_plan(tier))
            (world_table if w > 1 else launch_table)[f"append_{tier}"] = {4: launches}
            q_wall, q_runs, _ = warm_walls(query, reps=2)
            summary[tier] = {"wall_ms": q_wall, "wall_ms_runs": q_runs}
        os.environ.pop("DJT_JOIN_MERGE")
        log("append", smoke_phase="5c", case="(i)" if w == 1 else "(iv)", ranks=w, odf=4,
            resident_rows=rows, appended_rows=n_app, touched=list(info["touched"]),
            flags="all False", total=want_total, rows_checked=want_total,
            same_rows_as_unprepared_combined=True, r_cap=new.r_cap, first_append_ms=first_ms,
            append_wall_ms=wall, append_wall_ms_runs=runs, append_peak_bytes=peak,
            append_peak_over_resident_bytes=peak - base, fresh_prepare_wall_ms=fresh,
            fresh_prepare_wall_ms_runs=fresh_runs, fresh_prepare_peak_bytes=fresh_peak,
            queries=summary, card=smi)
        del new, info, l_side, r_side, a_side
        torch.cuda.empty_cache()

    # (ii) rows of batch 0 only: the other batches keep their tensors.
    prep = dj.prepare_join_side(topo, right, rcnt, [0], cfg, left_capacity=rows)
    keys0 = absent_keys(gen, dev, combined.columns[0].data, 2 * rows, max(1, n_app // 10),
                        batch0_of=4)
    new, info = dj.append_to_prepared(topo, prep, *dj.shard_table(
        topo, appended_table(dj, keys0, combined.capacity)))
    check_append("5c(ii)", new, info, (0,))
    same = [new.batches[b] is prep.batches[b] for b in range(4)]
    if same != [False, True, True, True]:
        raise AssertionError(f"5c(ii): the untouched batches were not kept: {same}")
    log("append", smoke_phase="5c", case="(ii)", odf=4, appended_rows=keys0.numel(),
        touched=list(info["touched"]), untouched_batches_kept=True, flags="all False", card=smi)
    del prep, new, info, keys0

    # (iii) odf 1: the batch holds every resident row, no slack.
    cfg1 = dj.JoinConfig(key_range=(0, 2 * rows))
    prep = dj.prepare_join_side(topo, right, rcnt, [0], cfg1, left_capacity=rows)
    few = appended_table(dj, app.columns[0].data[:1000], build.capacity)
    _, info = dj.append_to_prepared(topo, prep, *dj.shard_table(topo, few))
    fired = [k for k, v in info.items() if k != "touched" and bool(v.any())]
    if fired != ["append_overflow"]:
        raise AssertionError(f"5c(iii): flags {fired}, expected append_overflow alone")
    log("append", smoke_phase="5c", case="(iii)", odf=1, appended_rows=1000,
        resident_capacity=prep.batches[0][0].shape[0], flags_fired=fired, card=smi)
    del prep, info, few

    # (v) a two-level topology refuses the append.
    topo2 = dj.make_topology([dev] * WORLD, intra_size=INTRA)
    small = dj.Table(tuple(dj.Column(c.data[: 4 * n_app], c.dtype) for c in build.columns))
    prep = dj.prepare_join_side(topo2, *dj.shard_table(topo2, small), [0], cfg)
    try:
        dj.append_to_prepared(topo2, prep, *dj.shard_table(topo2, app))
    except dj.PreparedPlanMismatch as e:
        log("append", smoke_phase="5c", case="(v)", ranks=WORLD, intra=INTRA, refused=str(e))
    else:
        raise AssertionError("5c(v): a two-level topology's append was not refused")
    del prep, small, app, combined, ref
    torch.cuda.empty_cache()
    log("append_phase", smoke_phase="5c", seconds=time.perf_counter() - t_phase)
    return launch_table, world_table


# --- string columns on the prepared side (phase 8e) ------------------------

def slice_rows(dj, table, a: int, b: int):
    """Rows [a, b) of a table, string columns rebased."""
    cols = []
    for c in table.columns:
        if isinstance(c, dj.StringColumn):
            lo = int(c.offsets[a])
            cols.append(dj.StringColumn(c.offsets[a : b + 1] - lo,
                                        c.chars[lo : int(c.offsets[b])].clone(), c.dtype))
        else:
            cols.append(dj.Column(c.data[a:b], c.dtype))
    return dj.Table(tuple(cols))


def as_orders_lineitem(dj, out):
    """A prepared query's (L_ORDERKEY, L_PARTKEY, L_QUANTITY, O_CUSTKEY,
    O_ORDERPRIORITY) in 8a's column order."""
    lk, pk, q, ck, pri = out.columns
    return dj.Table((lk, ck, pri, pk, q), out.valid_count)


def run_prepared_strings(dj, dev, orders, lineitem, li_sorted, smi: str) -> tuple[dict, dict]:
    """Phase 8e: orders (O_ORDERKEY, O_CUSTKEY, O_ORDERPRIORITY) prepared,
    lineitem queried under each tier at odf 1 and 4 on one rank and odf
    1 in the 4-rank world, char_out_factor 5, each checked as 8a; the
    auto wrapper from char_out_factor 1 heals char_overflow; 1M orders
    held back, then appended, and the query checked as 8a; a string key
    refused. Returns ({path: {odf: launches}}, the same of the world)."""
    from dj_tpu_torch.ops.join import prepared_effective_plan

    t_phase = time.perf_counter()
    launch_table: dict = {}
    world_table: dict = {}

    def query_checked(what, t, w, odf, l_side, prep, cfg):
        reset_launches()
        with PassTimer() as timer:
            out, counts, info = dj.distributed_inner_join(t, *l_side, prep, None, [0], None, cfg)
            torch.cuda.synchronize()
        launches = read_launches()
        set_flags = [k for k, v in info.items() if bool(v.any())]
        if set_flags:
            raise AssertionError(f"{what}: flags set: {set_flags}")
        check_orders_lineitem(what, dj, as_orders_lineitem(dj, out), counts, orders, lineitem,
                              li_sorted)
        tier = os.environ.get("DJT_JOIN_MERGE", "sort")
        wrong = {k: launches[k] for k in prepared_effective_plan(tier) if launches[k] != w * odf}
        if wrong:
            raise AssertionError(f"{what}: each kernel must launch {w * odf} times: {wrong}")
        return launches, timer.ms()

    for w, odfs in ((1, (1, 4)), (WORLD, (1,))):
        t = dj.make_topology() if w == 1 else dj.make_topology([dev] * WORLD)
        r_side, l_side = dj.shard_table(t, orders), dj.shard_table(t, lineitem)
        for odf in odfs:
            cfg = dj.JoinConfig(over_decom_factor=odf, char_out_factor=CHAR_FIT)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            prep = dj.prepare_join_side(t, *r_side, [0], cfg, left_capacity=lineitem.capacity)
            torch.cuda.synchronize()
            prep_ms = (time.perf_counter() - t0) * 1e3
            for tier in TIERS:
                os.environ["DJT_JOIN_MERGE"] = tier
                what = f"8e world {w} odf {odf} tier {tier}"
                launches, passes = query_checked(what, t, w, odf, l_side, prep, cfg)
                (world_table if w > 1 else launch_table).setdefault(
                    f"tpch_prepared_{tier}", {})[odf] = launches
                wall, runs, peak = warm_walls(
                    lambda: dj.distributed_inner_join(t, *l_side, prep, None, [0], None, cfg),
                    reps=2)
                log("tpch_prepared", smoke_phase="8e", ranks=w, odf=odf, tier=tier,
                    build="orders (O_ORDERKEY, O_CUSTKEY, O_ORDERPRIORITY)",
                    probe="lineitem", char_out_factor=CHAR_FIT, total=lineitem.capacity,
                    flags="all False", rows_checked=lineitem.capacity, priorities_checked=True,
                    launches=launches, first_prepare_ms=prep_ms, wall_ms=wall,
                    wall_ms_runs=runs, peak_bytes=peak, string_pass_ms=passes, card=smi)
            os.environ.pop("DJT_JOIN_MERGE")
            del prep
        del r_side, l_side
        torch.cuda.empty_cache()

    # The char_overflow heal on the prepared path, from factor 1.
    topo = dj.make_topology()
    r_side, l_side = dj.shard_table(topo, orders), dj.shard_table(topo, lineitem)
    prep = dj.prepare_join_side(topo, *r_side, [0], left_capacity=lineitem.capacity)
    with Attempts() as a:
        t0 = time.perf_counter()
        out, counts, info, used, _ = dj.distributed_inner_join_auto(
            topo, *l_side, prep, None, [0], None, dj.JoinConfig(char_out_factor=1.0))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if any(bool(v.any()) for v in info.values()) or a.n < 2 or used.char_out_factor <= 1.0:
        raise AssertionError(f"8e: no char_overflow heal ({a.n} attempts, factor "
                             f"{used.char_out_factor}, flags {info})")
    check_orders_lineitem("8e auto", dj, as_orders_lineitem(dj, out), counts, orders, lineitem,
                          li_sorted)
    log("tpch_prepared_auto", smoke_phase="8e", attempts=a.n, char_out_factor_from=1.0,
        char_out_factor_used=used.char_out_factor, total=lineitem.capacity, flags="all False",
        priorities_checked=True, wall_ms=wall, card=smi)
    del out, counts, info, prep, r_side

    # 1M orders held back from the prepare, then appended with their
    # priorities: every lineitem matches again.
    n = orders.capacity
    m = min(1_000_000, n // 10)
    okeys = orders.columns[0].data
    cfg = dj.JoinConfig(over_decom_factor=4, char_out_factor=CHAR_FIT,
                        key_range=(int(okeys.min()), int(okeys.max())))
    head, tail = slice_rows(dj, orders, 0, n - m), slice_rows(dj, orders, n - m, n)
    prep = dj.prepare_join_side(topo, *dj.shard_table(topo, head), [0], cfg,
                                left_capacity=lineitem.capacity)
    a_side = dj.shard_table(topo, tail)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, info = dj.append_to_prepared(topo, prep, *a_side)
    torch.cuda.synchronize()
    append_ms = (time.perf_counter() - t0) * 1e3
    append_peak = torch.cuda.max_memory_allocated()
    set_flags = [k for k, v in info.items() if k != "touched" and bool(v.any())]
    if set_flags or info["touched"] != (0, 1, 2, 3):
        raise AssertionError(f"8e append: flags {set_flags}, touched {info['touched']}")
    fresh, _, _ = warm_walls(lambda: dj.prepare_join_side(
        topo, new.right, new.right_counts, [0], cfg, left_capacity=lineitem.capacity), reps=1)
    for tier in TIERS:
        os.environ["DJT_JOIN_MERGE"] = tier
        launches, _ = query_checked(f"8e after append tier {tier}", topo, 1, 4, l_side, new, cfg)
        launch_table[f"tpch_prepared_append_{tier}"] = {4: launches}
    os.environ.pop("DJT_JOIN_MERGE")
    log("tpch_prepared_append", smoke_phase="8e", odf=4, resident_orders=n - m, appended_orders=m,
        touched=list(info["touched"]), flags="all False", total=lineitem.capacity,
        priorities_checked=True, append_ms=append_ms, append_peak_bytes=append_peak,
        fresh_prepare_wall_ms=fresh, card=smi)
    del prep, new, info, head, tail, a_side, l_side

    # A string key: dj_tpu's ValueError.
    keyed = dj.Table((orders.columns[2], orders.columns[0]))
    try:
        dj.prepare_join_side(topo, *dj.shard_table(topo, keyed), [0])
    except ValueError as e:
        log("tpch_prepared_string_key", smoke_phase="8e", refused=str(e))
    else:
        raise AssertionError("8e: a string key was not refused")
    torch.cuda.empty_cache()
    log("tpch_prepared_phase", smoke_phase="8e", seconds=time.perf_counter() - t_phase)
    return launch_table, world_table


# --- the composition layers (phases 4j, 4k, 5f, 8g and the warmups) --------


class StageCalls:
    """Per pipeline stage, the attempts ``parallel.pipeline`` dispatched
    and the in-process transport's all-to-alls they issued, while
    active."""

    def __enter__(self):
        from dj_tpu_torch.parallel import pipeline
        from dj_tpu_torch.parallel.communicator import InProcessTransport

        self.mod, self.orig = pipeline, pipeline._dispatch_stage
        self.attempts: dict = {}
        self.all_to_alls: dict = {}
        self.stage = None
        self.cls, self.a2a = InProcessTransport, InProcessTransport.all_to_all_start

        def dispatch(topology, sp, *a, **k):
            self.stage = sp.index
            self.attempts[sp.index] = self.attempts.get(sp.index, 0) + 1
            self.all_to_alls.setdefault(sp.index, 0)
            try:
                return self.orig(topology, sp, *a, **k)
            finally:
                self.stage = None

        def a2a(transport, *a, **k):
            if self.stage is not None:
                self.all_to_alls[self.stage] += 1
            return self.a2a(transport, *a, **k)

        pipeline._dispatch_stage = dispatch
        InProcessTransport.all_to_all_start = a2a
        return self

    def __exit__(self, *exc):
        self.mod._dispatch_stage = self.orig
        self.cls.all_to_all_start = self.a2a


class Epochs:
    """The exchange epochs ``parallel.dist_join`` starts while active:
    each rank starts its part of an epoch, so a world of n ranks counts n
    calls an epoch."""

    def __enter__(self):
        from dj_tpu_torch.parallel import dist_join

        self.mod, self.orig, self.n = dist_join, dist_join.shuffle_tables_start, 0

        def start(*a, **k):
            self.n += 1
            return self.orig(*a, **k)

        dist_join.shuffle_tables_start = start
        return self

    def __exit__(self, *exc):
        self.mod.shuffle_tables_start = self.orig


def stage_phases(fn) -> dict:
    """One call of a pipeline with each rank's device ms by phase, per
    stage (one run_spmd a stage), and the call's wall."""
    from dj_tpu_torch.parallel import spmd

    with spmd.record_phases() as runs:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    del res
    return {"wall_ms": wall, "stage_phase_ms_by_rank": runs}


def chain_rows(what: str, dj, out, counts, build, probe, expected: int):
    """4j's rows (k, lp, rp, rp2): as check_rows for (k, lp, rp), and rp2
    == rp (the second build table is a copy of the first, whose keys are
    unique). Returns (k, lp, rp) ordered by probe row, as sorted_rows."""
    flat = dj.unshard_table(out, counts) if counts.shape[0] > 1 else out
    n = int(counts.sum())
    if n != expected:
        raise AssertionError(f"{what}: {n} rows, expected {expected}")
    k, lp, rp, rp2 = (c.data[:n] for c in flat.columns)
    if not bool((probe.columns[0].data[lp] == k).all()):
        raise AssertionError(f"{what}: a row's probe key differs from its key column")
    if not bool((build.columns[0].data[rp] == k).all()):
        raise AssertionError(f"{what}: a row's build key differs from its key column")
    if not torch.equal(rp2, rp):
        raise AssertionError(f"{what}: a row's second build row is not its first")
    order = torch.sort(lp).indices
    if n > 1 and bool((lp[order][1:] == lp[order][:-1]).any()):
        raise AssertionError(f"{what}: a probe row appears in two output rows")
    return k[order], lp[order], rp[order]


def chain_tables(dj, topo, build, probe):
    """4j's (and 6b's) sharded tables: probe and build, and the build
    table again, hash-partitioned by its key under the main join seed
    over the world (``shuffle_on(..., seed=12345678)``): a right side
    co-partitioned with a shuffle stage's output at any odf. Its output
    capacity is 2.5 times a rank's rows: the re-shuffle contrasts send
    each rank's rows of it to one peer, into a bucket of bucket_factor /
    n = half its capacity."""
    from dj_tpu_torch.parallel.dist_join import MAIN_JOIN_SEED

    left, lcnt = dj.shard_table(topo, probe)
    right, rcnt = dj.shard_table(topo, build)
    b2, b2c, ovf = dj.shuffle_on(topo, right, rcnt, [0], seed=MAIN_JOIN_SEED, out_factor=2.5)
    if bool(ovf.any()):
        raise AssertionError(f"the co-partitioned build copy overflowed: {ovf.tolist()}")
    return left, lcnt, right, rcnt, b2, b2c


def chain_stages(dj, right, rcnt, b2, b2c):
    """Stage 0: probe JOIN build on key 0 (a shuffle); stage 1: the
    intermediate JOIN the co-partitioned build copy on key 0."""
    return [dj.JoinStage(right=right, right_counts=rcnt, left_on=(0,), right_on=(0,),
                         mode="shuffle"),
            dj.JoinStage(right=b2, right_counts=b2c, left_on=(0,), right_on=(0,),
                         right_partitioned=True)]


def plan_view(plan) -> list:
    """Each stage's (mode, key range, range source, output partitioning),
    in JSON's lists (as a process world's RESULT line carries it)."""
    return json.loads(json.dumps([[sp.mode, sp.key_range, sp.range_source,
                                   sp.out_partitioned_by] for sp in plan.stage_plans]))


def run_warmups(dj, dev, smi: str) -> dict:
    """warmup_all_to_all of 10 MB over 4d's world and over both axes of
    4e's, each with its wall."""
    out = {}
    for name, intra in (("world4", None), ("two_level", INTRA)):
        topo = dj.make_topology([dev] * WORLD, intra_size=intra)
        t0 = time.perf_counter()
        dj.warmup_all_to_all(topo)
        out[name] = {"axes": list(topo.axis_names), "wall_ms": (time.perf_counter() - t0) * 1e3}
    log("warmup_all_to_all", smoke_phase="warmups", nbytes=10_000_000, **out, card=smi)
    return out


def run_pipeline_chain(dj, dev, build, probe, expected: int, ref, rows: int, smi: str) -> dict:
    """Phase 4j: a two-stage chain in 4d's world at odf 1 and 4 (module
    docstring). Returns {path: {odf: launches}}."""
    from dj_tpu_torch.parallel import dist_join

    topo = dj.make_topology([dev] * WORLD)
    left, lcnt, right, rcnt, b2, b2c = chain_tables(dj, topo, build, probe)
    check_colocated("4j build copy", b2, b2c, 1)
    stages = chain_stages(dj, right, rcnt, b2, b2c)
    torch.cuda.synchronize()
    launch_table: dict = {}
    for odf in (1, 4):
        cfg = dj.JoinConfig(over_decom_factor=odf)
        before = dist_join.range_probes
        plan = dj.plan_pipeline(topo, left, lcnt, stages, cfg)
        probes = dist_join.range_probes - before
        dj.plan_pipeline(topo, left, lcnt, stages, cfg)
        replan_probes = dist_join.range_probes - before - probes
        if [sp.mode for sp in plan.stage_plans] != ["shuffle", "local"]:
            raise AssertionError(f"4j odf={odf}: plan {plan_view(plan)}")
        # 3 probes at the first plan: the keys of probe, build and the build
        # copy, the chain's inputs; none of the intermediate, none again.
        if probes != (3 if odf == 1 else 0) or replan_probes:
            raise AssertionError(f"4j odf={odf}: {probes} range probes, {replan_probes} on a "
                                 f"re-plan")

        def chain():
            return dj.distributed_join_pipeline(topo, left, lcnt, stages, cfg, plan=plan)

        reset_launches()
        with Collectives() as c0:
            res = dj.distributed_join_pipeline(topo, left, lcnt, stages[:1], cfg)
            torch.cuda.synchronize()
        stage0 = read_launches()
        del res
        reset_launches()
        with Collectives() as coll:
            out, counts, infos = chain()
            torch.cuda.synchronize()
        launches = read_launches()
        for i, info in enumerate(infos):
            flags_false(f"4j odf={odf} stage {i}", info)
        got = chain_rows(f"4j odf={odf}", dj, out, counts, build, probe, expected)
        check_same_rows(got, ref, f"4j odf={odf}")
        del out, counts, infos, got
        if coll.counts != c0.counts:
            raise AssertionError(f"4j odf={odf}: the local stage issued collectives: chain "
                                 f"{coll.counts}, stage 0 alone {c0.counts}")
        for k in ("join_scans", "expand_values"):
            if stage0[k] != WORLD * odf or launches[k] != WORLD * odf + WORLD:
                raise AssertionError(f"4j odf={odf}: {k} launched {stage0[k]} by stage 0 and "
                                     f"{launches[k]} by the chain, not {WORLD * odf} and "
                                     f"{WORLD * odf} + {WORLD} (the local stage once a rank)")
        launch_table.setdefault("pipeline_local_chain", {})[odf] = launches
        wall, runs, peak = warm_walls(chain)
        phases = stage_phases(chain)

        # The contrasts at odf 4 only: at odf 1 each exchange's buckets
        # hold half a rank's capacity of the 50M-slot intermediate and the
        # 62.5M-slot copy, and the four ranks' peak 74.8 GB of the 80.
        contrasts = {}
        if odf == 4:
            contrasts = chain_contrasts(dj, topo, left, lcnt, right, rcnt, b2, b2c, stages, cfg,
                                        build, probe, expected, ref, launch_table)
        log("pipeline_chain", smoke_phase="4j", ranks=WORLD, odf=odf, rows=rows, total=expected,
            plan=plan_view(plan), range_probes_first_plan=probes, range_probes_replan=0,
            flags="all False", rows_checked=expected, same_rows_as_phase_4=True,
            local_stage_collectives=0, collectives_chain=coll.counts, launches_stage0=stage0,
            launches=launches, wall_ms=wall, wall_ms_runs=runs, peak_bytes=peak, phases=phases,
            **contrasts, card=smi)
        torch.cuda.empty_cache()
    del left, right, b2, stages
    torch.cuda.empty_cache()
    return launch_table


def chain_contrasts(dj, topo, left, lcnt, right, rcnt, b2, b2c, stages, cfg, build, probe,
                    expected: int, ref, launch_table: dict) -> dict:
    """4j's contrasts of its chain: the same chain re-shuffled
    (DJT_PIPELINE_COPART=0, DJT_PIPELINE_BROADCAST=0) and two composed
    distributed_inner_join calls, each checked as the chain and timed;
    their log fields."""
    odf = cfg.over_decom_factor
    with env_set(DJT_PIPELINE_COPART="0", DJT_PIPELINE_BROADCAST="0"):
        rplan = dj.plan_pipeline(topo, left, lcnt, stages, cfg)
        if [sp.mode for sp in rplan.stage_plans] != ["shuffle", "shuffle"]:
            raise AssertionError(f"4j re-shuffle: plan {plan_view(rplan)}")

        def reshuffle():
            return dj.distributed_join_pipeline(topo, left, lcnt, stages, cfg, plan=rplan)

        reset_launches()
        with Collectives() as rcoll:
            out, counts, infos = reshuffle()
            torch.cuda.synchronize()
        r_launches = read_launches()
        for i, info in enumerate(infos):
            flags_false(f"4j re-shuffle stage {i}", info)
        check_same_rows(chain_rows("4j re-shuffle", dj, out, counts, build, probe, expected), ref,
                        "4j re-shuffle")
        del out, counts, infos
        r_wall, r_runs, r_peak = warm_walls(reshuffle)
        r_phases = stage_phases(reshuffle)
    launch_table.setdefault("pipeline_reshuffle_chain", {})[odf] = r_launches

    def composed():
        o1, c1, i1 = dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)
        o2, c2, i2 = dj.distributed_inner_join(topo, o1, c1, b2, b2c, [0], [0], cfg)
        return o2, c2, [i1, i2]

    reset_launches()
    out, counts, infos = composed()
    torch.cuda.synchronize()
    c_launches = read_launches()
    for i, info in enumerate(infos):
        flags_false(f"4j composed call {i}", info)
    check_same_rows(chain_rows("4j composed", dj, out, counts, build, probe, expected), ref,
                    "4j composed")
    del out, counts, infos
    launch_table.setdefault("pipeline_composed_calls", {})[odf] = c_launches
    c_wall, c_runs, c_peak = warm_walls(composed)
    return {"same_rows_as_composed": True, "collectives_reshuffle": rcoll.counts,
            "reshuffle_plan": plan_view(rplan), "reshuffle_launches": r_launches,
            "reshuffle_wall_ms": r_wall, "reshuffle_wall_ms_runs": r_runs,
            "reshuffle_peak_bytes": r_peak, "reshuffle_phases": r_phases,
            "composed_launches": c_launches, "composed_wall_ms": c_wall,
            "composed_wall_ms_runs": c_runs, "composed_peak_bytes": c_peak}


def chain_rank(dj, dev, topo, spec: dict) -> dict:
    """6b's chain on one process: 4j's chain at odf 1 on a table of
    ``spec["chain_rows"]`` rows a side made from the seed; this
    process's plan, shard digest, flags and launches."""
    rows = spec["chain_rows"]
    gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 1)
    build, probe = dj.generate_build_probe_tables(gen, rows, rows, 0.3, 2 * rows, True)
    left, lcnt, right, rcnt, b2, b2c = chain_tables(dj, topo, build, probe)
    stages = chain_stages(dj, right, rcnt, b2, b2c)
    cfg = dj.JoinConfig()
    plan = dj.plan_pipeline(topo, left, lcnt, stages, cfg)
    reset_launches()
    out, counts, infos = dj.distributed_join_pipeline(topo, left, lcnt, stages, cfg, plan=plan)
    _sync(dev)
    return {"plan": plan_view(plan), "digest": shard_digest(out, int(counts[0])),
            "flags": [{k: v.tolist() for k, v in i.items()} for i in infos],
            "launches": read_launches()}


def chain_in_one_process(dj, dev, rows: int, seed: int) -> dict:
    """6b's chain in a 4-rank world of this process: the plan and rank
    r's shard digest, which each of 6b's processes must equal."""
    topo = dj.make_topology([dev] * WORLD)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    build, probe = dj.generate_build_probe_tables(gen, rows, rows, 0.3, 2 * rows, True)
    left, lcnt, right, rcnt, b2, b2c = chain_tables(dj, topo, build, probe)
    stages = chain_stages(dj, right, rcnt, b2, b2c)
    plan = dj.plan_pipeline(topo, left, lcnt, stages)
    out, counts, _ = dj.distributed_join_pipeline(topo, left, lcnt, stages, plan=plan)
    return {"plan": plan_view(plan), "digests": shard_digests(out, counts)}


def check_chain_processes(what: str, results: list, want: dict) -> None:
    """Each process's chain: the one-process world's plan on every
    process, flags False, its shard digest equal to rank r's."""
    for r, res in enumerate(results):
        c = res["chain"]
        if c["plan"] != want["plan"]:
            raise AssertionError(f"{what}: process {r} planned {c['plan']}, not {want['plan']}")
        if any(any(v) for f in c["flags"] for v in f.values()):
            raise AssertionError(f"{what}: process {r}'s chain set a flag")
        if c["digest"] != want["digests"][r]:
            raise AssertionError(f"{what}: process {r}'s digest {c['digest']} != "
                                 f"{want['digests'][r]}")


def q3_expected(orders, lineitem, n_cust: int):
    """(row of each orderkey, the lineitem words of every lineitem whose
    order's customer is in split 0's [0, n_cust), sorted): Q3's rows."""
    okeys, ocust = orders.columns[0].data, orders.columns[1].data
    base = int(okeys.min())
    row_of = torch.empty_like(okeys)
    row_of[okeys - base] = torch.arange(okeys.shape[0], device=okeys.device)
    lk, pk, q = (c.data for c in lineitem.columns)
    hit = ocust[row_of[lk - base]] < n_cust
    return base, row_of, torch.sort(lineitem_words(lk[hit], pk[hit], q[hit])).values


def check_q3_rows(what: str, dj, out, counts, orders, customer, base, row_of, want_words,
                  seg_code) -> torch.Tensor:
    """8g's rows (L_ORDERKEY, L_PARTKEY, L_QUANTITY, O_CUSTKEY,
    O_ORDERPRIORITY, C_MKTSEGMENT): the lineitem columns, as a multiset,
    are those of Q3's lineitems; each row's O_CUSTKEY and priority are
    its order's, its segment its customer's, byte for byte. Returns the
    sorted lineitem words."""
    from dj_tpu_torch.data import tpch

    flat = dj.unshard_table(out, counts) if counts.shape[0] > 1 else out
    n = int(counts.sum())
    if n != want_words.shape[0]:
        raise AssertionError(f"{what}: {n} rows, expected {want_words.shape[0]}")
    lk, pk, q, ck, pri, seg = flat.columns
    got = torch.sort(lineitem_words(lk.data[:n], pk.data[:n], q.data[:n])).values
    if not torch.equal(got, want_words):
        raise AssertionError(f"{what}: the lineitem columns differ from Q3's lineitems")
    rows = row_of[lk.data[:n] - base]
    if not torch.equal(ck.data[:n], orders.columns[1].data[rows]):
        raise AssertionError(f"{what}: an O_CUSTKEY differs from its order's")
    check_string_codes(what, pri, n, word_codes(orders.columns[2], tpch.PRIORITIES)[rows],
                       tpch.PRIORITIES)
    check_string_codes(what, seg, n, seg_code[ck.data[:n]], tpch.SEGMENTS)
    return got


def run_q3_pipeline(dj, dev, orders, lineitem, customer, n_cust: int, smi: str):
    """Phase 8g: TPC-H Q3's joins as one pipeline, as benchmarks/tpch.py
    --q3 runs them (distributed_join_pipeline_auto, every stage auto):
    lineitem JOIN orders on the orderkey, then the intermediate JOIN
    customer on O_CUSTKEY, at one rank and in the 4-rank world.
    join_out_factor 1 holds every row (each lineitem matches one order).
    Stage 0 runs at char_out_factor 5 (phase 8's fit: each priority is
    copied ~4 times); stage 1 at 1, with customer sharded at 6 times its
    segments' bytes of char capacity (each segment is copied ~5 times):
    one char_out_factor sizes both of stage 1's string columns, and 6
    would give O_ORDERPRIORITY 30 times orders' chars, whose string take
    needs more than the card's memory at this scale. The composed calls,
    distributed_inner_join_auto twice under DJT_PLAN_ADAPT=1 (the
    broadcast plan by fit, as the stages), run once. Returns ({path:
    {odf: launches}} of one rank, the same for the world)."""
    from dj_tpu_torch.data import tpch
    from dj_tpu_torch.resilience import ledger

    base, row_of, want_words = q3_expected(orders, lineitem, n_cust)
    ckey, cseg = customer.columns
    seg_code = torch.empty(n_cust, dtype=torch.int64, device=dev)
    seg_code[ckey.data] = word_codes(cseg, tpch.SEGMENTS)
    tables = ({}, {})
    seg_bytes = int(cseg.offsets[-1])
    for w in (1, WORLD):
        topo = dj.make_topology() if w == 1 else dj.make_topology([dev] * WORLD)
        li, o = dj.shard_table(topo, lineitem), dj.shard_table(topo, orders)
        c = dj.shard_table(topo, customer,
                           char_capacity_per_shard=int(CHAR_FIT_Q3 * seg_bytes / w) + 64)
        cfg = dj.JoinConfig(char_out_factor=CHAR_FIT)
        stages = [dj.JoinStage(right=o[0], right_counts=o[1], left_on=(0,), right_on=(0,)),
                  dj.JoinStage(right=c[0], right_counts=c[1], left_on=(3,), right_on=(0,),
                               config=dj.JoinConfig())]
        plan = dj.plan_pipeline(topo, *li, stages, cfg)
        if plan.stage_plans[1].mode != "broadcast":
            raise AssertionError(f"8g world {w}: stage 1 planned {plan_view(plan)}")
        what = f"8g world {w}"
        ledger.reset()
        reset_launches()
        with StageCalls() as calls, PassTimer() as timer:
            t0 = time.perf_counter()
            out, counts, infos, cfgs = dj.distributed_join_pipeline_auto(topo, *li, stages, cfg)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        for i, info in enumerate(infos):
            flags_false(f"{what} stage {i}", info)
        if calls.all_to_alls.get(1):
            raise AssertionError(f"{what}: stage 1 issued {calls.all_to_alls[1]} all-to-alls")
        words = check_q3_rows(what, dj, out, counts, orders, customer, base, row_of, want_words,
                              seg_code)
        del out, counts, infos
        for k in ("join_scans", "expand_values"):  # once a rank and stage attempt
            if launches[k] != w * sum(calls.attempts.values()):
                raise AssertionError(f"{what}: {k} launched {launches[k]} times for attempts "
                                     f"{calls.attempts}")
        tables[w > 1].setdefault("tpch_q3_pipeline", {})[1] = launches

        def composed():
            o1, c1, i1, _ = dj.distributed_inner_join_auto(topo, *li, *o, [0], [0], cfg)
            return dj.distributed_inner_join_auto(topo, o1, c1, *c, [3], [0], stages[1].config)

        # The composed calls on the pipeline's plans: under DJT_PLAN_ADAPT=1
        # both sides fit the broadcast budget, as in the stages (the
        # shuffle plan's string exchange of 75M lineitems does not fit
        # beside this phase's tables in the 4-rank world).
        torch.cuda.empty_cache()
        ledger.reset()
        with env_set(DJT_PLAN_ADAPT="1"):
            t0 = time.perf_counter()
            out, counts, info, _ = composed()
            torch.cuda.synchronize()
            c_wall = (time.perf_counter() - t0) * 1e3
        flags_false(f"{what} composed", info)
        if not torch.equal(check_q3_rows(f"{what} composed", dj, out, counts, orders, customer,
                                         base, row_of, want_words, seg_code), words):
            raise AssertionError(f"{what}: the pipeline's rows differ from the composed calls'")
        del out, counts, info

        def chain():
            return dj.distributed_join_pipeline_auto(topo, *li, stages, cfg)

        wall, runs, peak = warm_walls(chain)
        log("tpch_q3_pipeline", smoke_phase="8g", ranks=w, odf=1, plan=plan_view(plan),
            stages=["L_ORDERKEY = O_ORDERKEY", "O_CUSTKEY = C_CUSTKEY"],
            string_payloads=["O_ORDERPRIORITY", "C_MKTSEGMENT"], total=int(want_words.shape[0]),
            flags="all False", rows_checked=True, same_rows_as_composed=True,
            attempts_by_stage=calls.attempts, all_to_alls_by_stage=calls.all_to_alls,
            factors_by_stage=[{f: getattr(cf, f) for f in FACTOR_FIELDS} for cf in cfgs],
            launches=launches, first_call_ms=first_ms, string_pass_ms=timer.ms(),
            wall_ms=wall, wall_ms_runs=runs, peak_bytes=peak, composed_broadcast_plan_wall_ms=c_wall,
            card=smi)
        ledger.reset()
        del li, o, c, stages, plan
        torch.cuda.empty_cache()
    return tables


def member_rows(what: str, dj, out, counts, build, probe, ref, lo: int, hi: int):
    """A coalesced member's rows, checked as phase 4's and equal to
    ``ref``'s rows of the probe rows [lo, hi) (the member's slice of the
    probe table). Returns them as sorted_rows."""
    flat = dj.unshard_table(out, counts) if counts.shape[0] > 1 else out
    n = int(counts.sum())
    k, lp, rp = (c.data[:n] for c in flat.columns)
    order = torch.sort(lp).indices
    got = k[order], lp[order], rp[order]  # the payloads hold the global row ids
    in_slice = (ref[1] >= lo) & (ref[1] < hi)
    want = tuple(x[in_slice] for x in ref)
    check_same_rows(got, want, what)
    if not bool((probe.columns[0].data[got[1]] == got[0]).all()):
        raise AssertionError(f"{what}: a row's probe key differs from its key column")
    return got


def run_coalesced_prepared(dj, dev, gen, build, probe, expected: int, ref, rows: int,
                           smi: str) -> dict:
    """Phase 5f: distributed_inner_join_coalesced in 4d's world, K = 4
    members (the probe table cut into four slices of rows / 4, a fourth
    of a rank's rows each), against phase 5's prepared side at odf 1
    and 4 under each merge tier, and against 5e's broadcast-prepared side
    at odf 1. Returns {path: {odf: launches}}."""
    from dj_tpu_torch.ops.join import prepared_effective_plan

    topo = dj.make_topology([dev] * WORLD)
    right, rcnt = dj.shard_table(topo, build)
    m = rows // WORLD
    members = [dj.shard_table(topo, slice_rows(dj, probe, q * m, (q + 1) * m))
               for q in range(WORLD)]
    lefts, lcounts = [t for t, _ in members], [c for _, c in members]
    left, lcnt = dj.shard_table(topo, probe)
    torch.cuda.synchronize()
    launch_table: dict = {}
    k = len(members)
    for side, odfs in (("shuffle", (1, 4)), ("broadcast", (1,))):
        for odf in odfs:
            # A member holds a fourth of the probe rows: a fourth of phase
            # 5's join_out_factor gives it phase 5's output slack (at 1.0
            # the four members' outputs and their rank concatenation need
            # more than the card's memory beside the resident sides).
            cfg = dj.JoinConfig(over_decom_factor=odf, key_range=(0, 2 * rows),
                                join_out_factor=1.0 / WORLD)
            whole_cfg = dj.JoinConfig(over_decom_factor=odf, key_range=(0, 2 * rows))
            with env_set(DJT_PREPARED_TIER=side):
                prep = dj.prepare_join_side(topo, right, rcnt, [0], cfg, left_capacity=m)
                if prep.tier != side:
                    raise AssertionError(f"5f: prepared tier {prep.tier}, not {side}")
                cold_ms = warm_ms = warmup_ms = None
                if odf == 1:
                    # The first coalesced call on a fresh side, then on a
                    # side warmed by warmup_prepared_join.
                    t0 = time.perf_counter()
                    dj.distributed_inner_join_coalesced(topo, lefts, lcounts, prep, [0], cfg)
                    torch.cuda.synchronize()
                    cold_ms = (time.perf_counter() - t0) * 1e3
                    warmed = dj.prepare_join_side(topo, right, rcnt, [0], cfg, left_capacity=m)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    dj.warmup_prepared_join(topo, warmed, lefts[0], lcounts[0], [0], cfg)
                    warmup_ms = (time.perf_counter() - t0) * 1e3
                    t0 = time.perf_counter()
                    dj.distributed_inner_join_coalesced(topo, lefts, lcounts, warmed, [0], cfg)
                    torch.cuda.synchronize()
                    warm_ms = (time.perf_counter() - t0) * 1e3
                    del warmed
                whole = (dj.prepare_join_side(topo, right, rcnt, [0], whole_cfg,
                                              left_capacity=rows) if odf == 1 else None)
            for tier in TIERS:
                os.environ["DJT_JOIN_MERGE"] = tier
                what = f"5f {side} odf={odf} tier={tier}"

                def coalesced():
                    return dj.distributed_inner_join_coalesced(topo, lefts, lcounts, prep, [0],
                                                               cfg)

                reset_launches()
                with Epochs() as ep, Collectives() as coll:
                    per_query, used = coalesced()
                    torch.cuda.synchronize()
                launches = read_launches()
                want_epochs = 0 if side == "broadcast" else WORLD * odf
                if ep.n != want_epochs or (side == "broadcast" and any(coll.counts.values())):
                    raise AssertionError(f"{what}: {ep.n} epoch starts, not {want_epochs}; "
                                         f"collectives {coll.counts}")
                batches = 1 if side == "broadcast" else odf
                bad = {kk: launches[kk] for kk in prepared_effective_plan(tier)
                       if launches[kk] != WORLD * batches * k}
                if bad:
                    raise AssertionError(f"{what}: {bad}, not {WORLD * batches * k} each (a "
                                         f"member, rank and batch)")
                got = []
                for q, (out, counts, info) in enumerate(per_query):
                    flags_false(f"{what} member {q}", info)
                    got.append(member_rows(f"{what} member {q}", dj, out, counts, build, probe,
                                           ref, q * m, (q + 1) * m))
                del per_query
                if sum(g[0].shape[0] for g in got) != expected:
                    raise AssertionError(f"{what}: the members' rows do not sum to {expected}")

                def singletons():
                    return [dj.distributed_inner_join(topo, lefts[q], lcounts[q], prep, None, [0],
                                                      None, cfg) for q in range(k)]

                with Epochs() as sep:
                    alone = singletons()
                    torch.cuda.synchronize()
                for q, (out, counts, info) in enumerate(alone):
                    flags_false(f"{what} singleton {q}", info)
                    check_same_rows(member_rows(f"{what} singleton {q}", dj, out, counts, build,
                                                probe, ref, q * m, (q + 1) * m), got[q], what)
                del alone, got
                launch_table.setdefault(f"coalesced_prepared_{side}_{tier}", {})[odf] = launches
                timed = odf == 1 or tier == "sort"
                wall, runs, peak = warm_walls(coalesced) if timed else (None, [], None)
                s_wall, s_runs, s_peak = warm_walls(singletons) if timed else (None, [], None)
                w_wall = w_runs = None
                if whole is not None:
                    w_wall, w_runs, _ = warm_walls(lambda: dj.distributed_inner_join(
                        topo, left, lcnt, whole, None, [0], None, whole_cfg))
                log("coalesced_prepared", smoke_phase="5f", ranks=WORLD, side=side, odf=odf,
                    tier=tier, members=k, member_rows=m, rows_per_rank_member=m // WORLD,
                    config_used_join_out_factor=used.join_out_factor, flags="all False",
                    rows_checked=expected, members_equal_singletons=True,
                    union_equals_phase_5=True, epoch_starts=ep.n,
                    singleton_epoch_starts=sep.n, collectives=coll.counts, launches=launches,
                    wall_ms=wall, wall_ms_runs=runs, peak_bytes=peak,
                    four_singletons_wall_ms=s_wall, four_singletons_wall_ms_runs=s_runs,
                    four_singletons_peak_bytes=s_peak, whole_table_query_wall_ms=w_wall,
                    whole_table_query_wall_ms_runs=w_runs,
                    first_call_ms_fresh_side=cold_ms if tier == TIERS[0] else None,
                    first_call_ms_after_warmup=warm_ms if tier == TIERS[0] else None,
                    warmup_prepared_join_ms=warmup_ms if tier == TIERS[0] else None,
                    card=smi)
            os.environ.pop("DJT_JOIN_MERGE")
            del prep, whole
            torch.cuda.empty_cache()
    del members, lefts, lcounts, left, right
    torch.cuda.empty_cache()
    return launch_table


def bucket_sizes(sb, per_rank: int) -> tuple[int, list]:
    """(the bucket of ``per_rank`` rows a shard, four per-shard sizes
    strictly between the grid point below it and it): four raw shapes,
    each padded, that land in one bucket."""
    import math

    b = sb.bucket_capacity(per_rank)
    prev, g = sb.grid_floor(), sb.grid_floor()
    while g < b:
        prev, g = g, max(g + 1, math.ceil(g * sb.grid_ratio()))
    step = (b - prev) // 5
    return b, [b - (i + 1) * step for i in range(4)]


def run_coalesced_bucketed(dj, dev, build, probe, rows: int, smi: str) -> dict:
    """Phase 4k: distributed_inner_join_coalesced_unprepared under
    DJT_SHAPE_BUCKET=1 in 4d's world at odf 1: K = 4 member pairs cut
    from 4d's tables (probe and build rows [q rows / 4, ...)) at four raw
    sizes near rows / 4 that land in one bucket. Returns {path: {odf:
    launches}}."""
    from dj_tpu_torch.parallel import shape_bucket

    topo = dj.make_topology([dev] * WORLD)
    with env_set(DJT_SHAPE_BUCKET="1"):
        bucket, per_shard = bucket_sizes(shape_bucket, rows // WORLD // WORLD)
    sizes = [WORLD * s for s in per_shard]
    starts = [q * (rows // WORLD) for q in range(WORLD)]
    if starts[-1] + sizes[0] > rows:
        starts = [q * (rows - sizes[0]) // (WORLD - 1) for q in range(WORLD)]
    lefts, rights, expected = [], [], []
    for a, n in zip(starts, sizes):
        lt = slice_rows(dj, probe, a, a + n)
        rt = slice_rows(dj, build, a, a + n)
        expected.append(key_matches(rt.columns[0].data, lt.columns[0].data))
        lefts.append(dj.shard_table(topo, lt))
        rights.append(dj.shard_table(topo, rt))
    cfg = dj.JoinConfig()
    args = ([t for t, _ in lefts], [c for _, c in lefts], [t for t, _ in rights],
            [c for _, c in rights], [0], [0], cfg)

    def singletons():
        return [dj.distributed_inner_join(topo, *lefts[q], *rights[q], [0], [0], cfg)
                for q in range(WORLD)]

    alone = singletons()
    want = []
    for q, (out, counts, info) in enumerate(alone):
        flags_false(f"4k singleton {q}", info)
        want.append(pair_words(out, counts, build, probe, expected[q], f"4k singleton {q}"))
    del alone
    s_wall, s_runs, s_peak = warm_walls(singletons)
    with env_set(DJT_SHAPE_BUCKET="1"):
        pads = dict(shape_bucket.totals)
        reset_launches()
        with Epochs() as ep:
            per_query, used = dj.distributed_inner_join_coalesced_unprepared(topo, *args)
            torch.cuda.synchronize()
        launches = read_launches()
        padded = shape_bucket.totals["pad"] - pads["pad"]
        if ep.n != WORLD or padded != 2 * WORLD:
            raise AssertionError(f"4k: {ep.n} epoch starts (not {WORLD}), {padded} pads (not "
                                 f"{2 * WORLD}, each source once)")
        for q, (out, counts, info) in enumerate(per_query):
            flags_false(f"4k member {q}", info)
            if not torch.equal(pair_words(out, counts, build, probe, expected[q], f"4k member {q}"),
                               want[q]):
                raise AssertionError(f"4k member {q}: rows differ from its singleton join's")
        del per_query
        for kk in ("join_scans", "expand_values"):
            if launches[kk] != WORLD * WORLD:
                raise AssertionError(f"4k: {kk} launched {launches[kk]} times, not "
                                     f"{WORLD * WORLD} (a member and rank)")

        def coalesced():
            return dj.distributed_inner_join_coalesced_unprepared(topo, *args)

        wall, runs, peak = warm_walls(coalesced)
        repads = shape_bucket.totals["pad"] - pads["pad"] - padded
        if repads:
            raise AssertionError(f"4k: the warm calls padded {repads} tables again")
        with env_set(DJT_PLAN_ADAPT="1"):
            try:
                coalesced()
            except ValueError as e:
                refusal = str(e)
            else:
                raise AssertionError("4k: DJT_PLAN_ADAPT=1 was not refused")
    log("coalesced_bucketed", smoke_phase="4k", ranks=WORLD, odf=1, members=WORLD,
        bucket_rows_per_shard=bucket, raw_rows_per_shard=per_shard, raw_rows=sizes,
        pad_fraction=[1 - s / bucket for s in per_shard], totals=expected, flags="all False",
        members_equal_singletons=True, pads=padded, memo_hits_warm=shape_bucket.totals["memo_hit"]
        - pads["memo_hit"], epoch_starts=ep.n, launches=launches, wall_ms=wall,
        wall_ms_runs=runs, peak_bytes=peak, four_singletons_wall_ms=s_wall,
        four_singletons_wall_ms_runs=s_runs, four_singletons_peak_bytes=s_peak,
        plan_adapt_refused=refusal, card=smi)
    del lefts, rights, args
    torch.cuda.empty_cache()
    return {"coalesced_unprepared_bucketed": {1: launches}}


def first_join_with_warmup(dj, dev, backend: str, build, probe, smi: str) -> dict:
    """6a's warmup: in two fresh process worlds of one (NCCL on the
    card), the first join's wall, without and then after
    warmup_all_to_all (which makes the communicator)."""
    out = {}
    for warm in (False, True):
        dj.init_distributed(f"localhost:{free_port()}", 1, 0, backend=backend, device=dev.type)
        try:
            topo = dj.make_topology() if dev.type == "cuda" else dj.make_topology([dev])
            left, lcnt = dj.shard_table(topo, probe)
            right, rcnt = dj.shard_table(topo, build)
            _sync(dev)
            t0 = time.perf_counter()
            if warm:
                dj.warmup_all_to_all(topo)
            warmup_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            res = dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0])
            _sync(dev)
            out["after_warmup" if warm else "cold"] = {
                "first_join_ms": (time.perf_counter() - t0) * 1e3,
                "warmup_ms": warmup_ms if warm else None}
            flags_false(f"6a warmup={warm}", res[2])
            del res, left, right
        finally:
            torch.distributed.destroy_process_group()
    log("warmup_first_join", smoke_phase="6a", backend=backend, ranks=1, **out, card=smi)
    return out


# --- process worlds (phases 6a-6c) ---------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent


def free_port() -> int:
    """A free TCP port on localhost for a process group's store."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_world(world: int, argv: list, *, timeout: float, local_ranks: bool = False,
                env: Optional[dict] = None, cwd=ROOT) -> list:
    """Start ``world`` processes of ``python argv``, process r with the
    DJT_* variables of rank r of a process world on a localhost store
    (and LOCAL_RANK r when ``local_ranks``, else 0: every rank on card
    0). Waits for all; at ``timeout`` seconds kills every one left and
    raises. Returns (returncode, stdout, stderr) per rank."""
    port = free_port()
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(world):
            e = dict(os.environ, **(env or {}), DJT_COORDINATOR_ADDRESS=f"localhost:{port}",
                     DJT_NUM_PROCESSES=str(world), DJT_PROCESS_ID=str(r),
                     LOCAL_RANK=str(r if local_ranks else 0))
            out = open(pathlib.Path(tmp) / f"out{r}", "w+")
            err = open(pathlib.Path(tmp) / f"err{r}", "w+")
            procs.append((subprocess.Popen([sys.executable, *argv], cwd=cwd, env=e, stdout=out,
                                           stderr=err, text=True), out, err))
        deadline = time.monotonic() + timeout
        try:
            for p, _, _ in procs:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"a world of {world} processes did not end within {timeout} s")
        finally:
            for p, _, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for p, out, err in procs:
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
            out.close()
            err.close()
    return results


MIX = (0x9E3779B97F4A7C15 - 2**64, 0xBF58476D1CE4E5B9 - 2**64, 0x94D049BB133111EB - 2**64)


def shard_digest(table, count: int) -> list:
    """[rows, order-free hash] of a shard's first ``count`` rows: the
    wrapping int64 sum of one mixed word per row (int64 arithmetic, the
    same on the card and the CPU)."""
    h = torch.zeros(count, dtype=torch.int64, device=table.device)
    for j, c in enumerate(table.columns):
        x = c.data[:count]
        x = x.view(torch.int64) if x.element_size() == 8 else x.to(torch.int64)
        h = (h ^ x) * MIX[j % 3]
        h = h ^ (h >> 29)
    return [count, int(h.sum())]


def shard_digests(out, counts) -> list:
    """shard_digest of every shard of a sharded result."""
    cap = out.capacity // counts.shape[0]
    from dj_tpu_torch.core.table import Column, Table

    return [shard_digest(Table(tuple(Column(c.data[r * cap : (r + 1) * cap], c.dtype)
                                     for c in out.columns)), n)
            for r, n in enumerate(counts.tolist())]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def world_rank(spec_json: str) -> int:
    """One process of a process world (phases 6b and 6c): join phase 4's
    tables, of which every process makes the same global copy from the
    seed and keeps its own block, and print this rank's result as a
    ``RESULT {json}`` line: its shard's digest, every rank's flags, the
    generator's count, the kernels' launches, walls and the phase times
    of one more run."""
    spec = json.loads(spec_json)
    import dj_tpu_torch as dj
    from dj_tpu_torch.parallel import bootstrap, spmd
    from dj_tpu_torch.parallel.communicator import DistTransport

    dj.init_distributed(backend=spec["backend"], device=spec["device"])
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", bootstrap.local_device_index())
        torch.cuda.set_device(dev)
    try:
        topo = dj.make_topology([dev])
        rows = spec["rows"]
        gen = torch.Generator(device=dev).manual_seed(spec["seed"])
        build, probe, expected = dj.generate_build_probe_tables(
            gen, rows, rows, 0.3, 2 * rows, True, return_expected_matches=True)
        left, lcnt = dj.shard_table(topo, probe)
        right, rcnt = dj.shard_table(topo, build)
        del build, probe, gen
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cfg = dj.JoinConfig(over_decom_factor=spec["odf"])

        def join():
            return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)

        reset_launches()
        out, counts, info = join()
        _sync(dev)
        launches = read_launches()
        transport = DistTransport(dev)
        result = {
            "rank": topo.rank, "world": topo.world_size, "device": str(dev),
            "transport": transport.name, "host_staged_calls": list(transport.host_staged),
            "digest": shard_digest(out, int(counts[0])), "expected": int(expected),
            "flags": {k: v.tolist() for k, v in info.items()}, "launches": launches,
        }
        del out, counts, info
        runs = []
        for _ in range(spec["reps"]):
            t0 = time.perf_counter()
            res = join()
            _sync(dev)
            runs.append((time.perf_counter() - t0) * 1e3)
            del res
        result["wall_ms_runs"] = runs
        result["wall_ms"] = statistics.median(runs) if runs else None
        if dev.type == "cuda":
            result["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        with spmd.record_phases() as phase_runs:
            join()
            _sync(dev)
        result["phase_ms"] = phase_runs[-1][0]
        if spec.get("broadcast"):
            result["broadcast"] = broadcast_rank(dj, dev, topo, join, left, lcnt, right, rcnt,
                                                 cfg)
        if spec.get("intra"):
            if dev.type == "cuda":
                torch.cuda.empty_cache()  # four processes share the card
            result["two_level"] = two_level_rank(dj, dev, spec, left, lcnt, right, rcnt)
        if spec.get("chain_rows"):
            del left, right
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            result["chain"] = chain_rank(dj, dev, topo, spec)
        print("RESULT " + json.dumps(result), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def broadcast_rank(dj, dev, topo, join, left, lcnt, right, rcnt, cfg) -> dict:
    """Phase 6b's broadcast run on one process: under DJT_PLAN_ADAPT=1
    this process decides the plan on its own (from the gathered counts
    and the global build side's bytes), then joins once; its decision,
    shard digest, flags, launches and a warm wall."""
    from dj_tpu_torch.parallel import dist_join

    try:
        with env_set(DJT_PLAN_ADAPT="1"):
            dj.resilience.ledger.reset()
            d = dist_join._resolve_plan_decision(topo, left, lcnt, right, rcnt, (0,), (0,), cfg)
            reset_launches()
            out, counts, info = join()
            _sync(dev)
            res = {"decision": [d.tier, list(d.salt), d.replicas, d.ratio, d.source],
                   "digest": shard_digest(out, int(counts[0])),
                   "flags": {k: v.tolist() for k, v in info.items()},
                   "launches": read_launches()}
            del out, counts, info
            t0 = time.perf_counter()
            join()
            _sync(dev)
            res["wall_ms"] = (time.perf_counter() - t0) * 1e3
            if dev.type == "cuda":
                res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    finally:
        dj.resilience.ledger.reset()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # four processes share the card
    return res


def two_level_rank(dj, dev, spec: dict, left, lcnt, right, rcnt) -> dict:
    """The second half of a process of phase 6b (and 6c) at
    ``spec["intra"]``: the same blocks joined at odf 1 over a two-level
    process world (each 'inter' and 'intra' group a torch.distributed
    subgroup), then phase 4f's table shuffled on column 0 over 'inter'
    (seed 87654321) and 'intra'; the shard digests, flags, launches, a
    warm wall and the phase times of each."""
    from dj_tpu_torch.parallel import spmd
    from dj_tpu_torch.parallel.dist_join import INTER_DOMAIN_SEED

    topo = dj.make_topology([dev], intra_size=spec["intra"])
    cfg = dj.JoinConfig()

    def join():
        return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        return res, (time.perf_counter() - t0) * 1e3

    reset_launches()
    (out, counts, info), _ = timed(join)
    launches = read_launches()
    result = {"axes": list(topo.axis_names),
              "groups": [topo.group(a).size for a in topo.axis_names],
              "digest": shard_digest(out, int(counts[0])),
              "flags": {k: v.tolist() for k, v in info.items()}, "launches": launches}
    del out, counts, info
    result["wall_ms"] = timed(join)[1]
    with spmd.record_phases() as phase_runs:
        join()
        _sync(dev)
    result["phase_ms"] = phase_runs[-1][0]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    table = clickstream_table(dj, dev, spec["shuffle_rows"], spec["seed"])
    t, c = dj.shard_table(topo, table)
    del table

    def shuffle():
        a = dj.shuffle_on(topo, t, c, [0], group=topo.group("inter"), seed=INTER_DOMAIN_SEED)
        b = dj.shuffle_on(topo, a[0], a[1], [0], group=topo.group("intra"))
        return b, a[2] | b[2]

    (res, ovf), result["shuffle_wall_ms"] = timed(shuffle)
    result["shuffle_digest"] = shard_digest(res[0], int(res[1][0]))
    result["shuffle_overflow"] = ovf.tolist()
    del res

    # The codec over the process group: each rank samples its own block
    # and takes rank 0's options; then the table over 'inter', raw and
    # compressed, each with its exchange's device ms (gloo stages it
    # through the host).
    from dj_tpu_torch.compress import cascaded as cz

    local = dj.generate_auto_select_compression_options(t)
    agreed = dj.broadcast_compression_options(local)
    result["options_local"] = [cz._encode(o) for o in local]
    result["options_agreed"] = [cz._encode(o) for o in agreed]
    # Blocks of one distribution sample alike: a tree made to differ by
    # rank must come back as rank 0's too.
    ranked = with_wire_factor(local, 0.9 + 0.01 * topo.rank)
    result["options_ranked"] = [cz._encode(o) for o in ranked]
    result["options_ranked_agreed"] = [
        cz._encode(o) for o in dj.broadcast_compression_options(ranked)]

    def inter(comp):
        return dj.shuffle_on(topo, t, c, [0], group=topo.group("inter"), seed=INTER_DOMAIN_SEED,
                             compression=comp, with_stats=True)

    inter(agreed)  # the codec's first call
    for name, comp in (("raw", None), ("compressed", agreed)):
        with spmd.record_phases() as runs:
            res, wall = timed(lambda: inter(comp))
        result[f"inter_{name}"] = {
            "digest": shard_digest(res[0], int(res[1][0])), "overflow": res[2].tolist(),
            "wall_ms": wall, "exchange_ms": runs[-1][0].get("a2a_exchange"),
            "phase_ms": runs[-1][0], "stats": {k: v.tolist() for k, v in res[3].items()}}
        del res
    return result


def run_process_world(world: int, backend: str, device: str, rows: int, seed: int, *,
                      odf: int = 1, reps: int = 3, timeout: float = 600.0,
                      local_ranks: bool = False, intra: Optional[int] = None,
                      shuffle_rows: int = 0, broadcast: bool = False,
                      chain_rows: int = 0) -> list:
    """Phases 6b and 6c: ``world`` processes of ``world_rank``; returns
    their RESULT objects by rank. Every process must end with code 0 and
    print one; the flag matrices must be equal on all. With ``intra``
    each process also runs ``two_level_rank`` (``shuffle_rows`` rows of
    phase 4f's table), with ``broadcast`` ``broadcast_rank``, with
    ``chain_rows`` ``chain_rank``."""
    spec = json.dumps({"backend": backend, "device": device, "rows": rows, "seed": seed,
                       "odf": odf, "reps": reps, "intra": intra,
                       "shuffle_rows": shuffle_rows, "broadcast": broadcast,
                       "chain_rows": chain_rows})
    code = "import sys, chip_smoke; sys.exit(chip_smoke.world_rank(sys.argv[1]))"
    outs = spawn_world(world, ["-c", code, spec], timeout=timeout, local_ranks=local_ranks)
    results = []
    for r, (rc, out, err) in enumerate(outs):
        lines = [ln[len("RESULT "):] for ln in out.splitlines() if ln.startswith("RESULT ")]
        if rc != 0 or len(lines) != 1:
            raise AssertionError(f"process {r} of {world} ended with {rc}:\n{out[-3000:]}\n"
                                 f"{err[-3000:]}")
        results.append(json.loads(lines[0]))
    if [res["rank"] for res in results] != list(range(world)):
        raise AssertionError(f"ranks {[res['rank'] for res in results]}")
    if any(res["flags"] != results[0]["flags"] for res in results):
        raise AssertionError("the flag matrices differ between processes")
    if intra and any(res["two_level"]["flags"] != results[0]["two_level"]["flags"]
                     for res in results):
        raise AssertionError("the two-level flag matrices differ between processes")
    if broadcast and any(res["broadcast"]["flags"] != results[0]["broadcast"]["flags"]
                         for res in results):
        raise AssertionError("the broadcast plan's flag matrices differ between processes")
    return results


def check_broadcast_processes(what: str, results: list, want_digests: Optional[list],
                              expected: int, launches: int) -> None:
    """Each process's broadcast run (``broadcast_rank``): the same
    broadcast decision on every process, flags False, shard digests
    equal to phase 4i(i)'s rank r (when given) and summing to the
    generator's count, join_scans and expand_values launched
    ``launches`` times (once on the card)."""
    runs = [res["broadcast"] for res in results]
    decisions = [b["decision"] for b in runs]
    if decisions[0][0] != "broadcast" or any(d != decisions[0] for d in decisions):
        raise AssertionError(f"{what}: decisions {decisions}")
    set_flags = [k for k, v in runs[0]["flags"].items() if any(v)]
    if set_flags:
        raise AssertionError(f"{what}: broadcast flags set: {set_flags}")
    digests = [b["digest"] for b in runs]
    if want_digests is not None and digests != want_digests:
        raise AssertionError(f"{what}: broadcast shard digests {digests} != 4i(i)'s "
                             f"{want_digests}")
    if sum(d[0] for d in digests) != expected:
        raise AssertionError(f"{what}: broadcast shard rows do not sum to {expected}")
    for b in runs:
        bad = {k: b["launches"][k] for k in ("join_scans", "expand_values")
               if b["launches"][k] != launches}
        if bad:
            raise AssertionError(f"{what}: a broadcast process launched {bad}, not {launches} "
                                 f"each")


def check_two_level_processes(what: str, results: list, want_digests: Optional[list],
                              want_shuffle: Optional[list], expected: int,
                              launches: int) -> None:
    """The two-level half of each process (``two_level_rank``): flags
    False, the join's shard digests equal to phase 4e's rank r (when
    given) and summing to the generator's count, join_scans and
    expand_values launched ``launches`` times on every process (once on
    the card), and the shuffle's digests equal to phase 4f's two-level
    ones (when given), without overflow."""
    two = [res["two_level"] for res in results]
    set_flags = [k for k, v in two[0]["flags"].items() if any(v)]
    if set_flags:
        raise AssertionError(f"{what} two-level: flags set: {set_flags}")
    digests = [t["digest"] for t in two]
    if want_digests is not None and digests != want_digests:
        raise AssertionError(f"{what} two-level: shard digests {digests} != 4e's {want_digests}")
    if sum(d[0] for d in digests) != expected:
        raise AssertionError(f"{what} two-level: shard rows do not sum to {expected}")
    for r, t in enumerate(two):
        bad = {k: t["launches"][k] for k in ("join_scans", "expand_values")
               if t["launches"][k] != launches}
        if bad:
            raise AssertionError(f"{what} two-level: rank {r} launched {bad}, not {launches} "
                                 f"each")
        if any(t["shuffle_overflow"]):
            raise AssertionError(f"{what} two-level: shuffle_on overflow {t['shuffle_overflow']}")
    shuffled = [t["shuffle_digest"] for t in two]
    if want_shuffle is not None and shuffled != want_shuffle:
        raise AssertionError(f"{what} two-level: shuffle digests {shuffled} != 4f's "
                             f"{want_shuffle}")
    if any(t["options_agreed"] != two[0]["options_local"]
           or t["options_ranked_agreed"] != two[0]["options_ranked"] for t in two):
        raise AssertionError(f"{what} two-level: a process did not take rank 0's options")
    if len({json.dumps(t["options_ranked"]) for t in two}) != len(two):
        raise AssertionError(f"{what} two-level: the ranked trees do not differ by rank")
    for r, t in enumerate(two):
        raw, comp = t["inter_raw"], t["inter_compressed"]
        if raw["digest"] != comp["digest"] or any(raw["overflow"] + comp["overflow"]):
            raise AssertionError(f"{what} two-level: rank {r}'s compressed 'inter' shuffle "
                                 f"differs from the raw one")
        if not all(v > 0 for v in comp["stats"]["comp_actual_bytes"]):
            raise AssertionError(f"{what} two-level: rank {r} compressed nothing")


def check_process_world(what: str, results: list, want_digests: Optional[list],
                        expected: int, launches: int) -> None:
    """Each process's flags False, its shard's digest equal to rank r's
    of the world in one process (when given), the shard rows summing to
    the generator's count, and join_scans and expand_values launched
    ``launches`` times on every process (once a batch on the card)."""
    set_flags = [k for k, v in results[0]["flags"].items() if any(v)]
    if set_flags:
        raise AssertionError(f"{what}: flags set: {set_flags}")
    if any(res["expected"] != expected for res in results):
        raise AssertionError(f"{what}: a process generated other tables")
    digests = [res["digest"] for res in results]
    if want_digests is not None and digests != want_digests:
        raise AssertionError(f"{what}: shard digests {digests} != the in-process world's "
                             f"{want_digests}")
    if sum(d[0] for d in digests) != expected:
        raise AssertionError(f"{what}: shard rows {[d[0] for d in digests]} do not sum to "
                             f"{expected}")
    for res in results:
        bad = {k: res["launches"][k] for k in ("join_scans", "expand_values")
               if res["launches"][k] != launches}
        if bad:
            raise AssertionError(f"{what}: rank {res['rank']} launched {bad}, not {launches} each")


def check_transport(dj, dev) -> dict:
    """The process world's transport on the device's tensors (a world of
    one, phase 6a): all_to_all, fused and unfused exchange, shift, the
    chunked (Buffered) and the ring all-to-all, all_gather and the
    reductions, each equal to its input (what a world of one returns)."""
    from dj_tpu_torch.core.table import signed_view
    from dj_tpu_torch.parallel.communicator import DistTransport

    def same(a, b):
        return a.dtype == b.dtype and torch.equal(signed_view(a), signed_view(b))

    topo = dj.make_topology([dev])
    group = topo.world_group()
    transport = DistTransport(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    bufs = [torch.randint(-(2**62), 2**62, (1, 50, 3), generator=g, device=dev),
            torch.randint(-(2**31), 2**31 - 1, (1, 40), generator=g, device=dev).to(torch.int32),
            torch.randint(0, 2**62, (1, 33), generator=g, device=dev).view(torch.uint64),
            torch.randint(-(2**15), 2**15 - 1, (1, 17, 2), generator=g, device=dev).to(torch.int16),
            torch.rand((1, 9), generator=g, device=dev) < 0.5,
            torch.rand((1, 21), generator=g, device=dev)]
    checked = []
    for cls, kw in ((dj.XlaCommunicator, {}), (dj.BufferedCommunicator, {"chunk_rows": 7}),
                    (dj.RingCommunicator, {})):
        for fuse in (True, False):
            comm = cls(group, transport, fuse_columns=fuse, **kw)
            for name, got in (("all_to_all", [comm.all_to_all(b) for b in bufs]),
                              ("exchange", comm.exchange(bufs))):
                for b, o in zip(bufs, got):
                    if not same(o, b):
                        raise AssertionError(f"{cls.__name__} fuse={fuse} {name}: {b.dtype} differs")
            checked.append(f"{cls.__name__}(fuse={fuse})")
    for b in bufs:
        if not same(transport.shift_start(b[0], 1).wait(), b[0]):
            raise AssertionError(f"shift of {b.dtype} differs")
        if not same(transport.all_gather(b[0]), b):
            raise AssertionError(f"all_gather of {b.dtype} differs")
    for x in (bufs[0][0], bufs[2][0], bufs[5][0]):
        for op in ("max", "sum"):
            if not same(transport.all_reduce(x, op), x):
                raise AssertionError(f"all_reduce {op} of {x.dtype} differs")
    return {"transport": transport.name, "backends": checked,
            "dtypes": [str(b.dtype) for b in bufs],
            "calls": ["all_to_all", "exchange", "shift", "all_gather", "all_reduce"]}


def process_world_of_one(dj, dev, backend: str, build, probe, expected: int, ref, rows: int,
                         smi: str, reps: int = 3) -> dict:
    """Phase 6a: a process world of one on this process, under
    ``backend`` (NCCL on the card): phase 4's join at odf 1 and 4 with
    the default backend and at odf 1 with Ring and Buffered, and one
    prepared query per tier at odf 1, each checked as in phase 4 and
    against its rows, with one launch of each kernel per batch; then the
    transport itself (``check_transport``). Returns {path: {odf:
    launches}}."""
    from dj_tpu_torch.ops.join import prepared_effective_plan

    dj.init_distributed(f"localhost:{free_port()}", 1, 0, backend=backend, device=dev.type)
    try:
        topo = dj.make_topology() if dev.type == "cuda" else dj.make_topology([dev])
        if not topo.is_process_world or topo.world_size != 1:
            raise AssertionError(f"not a process world of one: {topo}")
        left, lcnt = dj.shard_table(topo, probe)
        right, rcnt = dj.shard_table(topo, build)
        launch_table: dict = {}

        def check(what, res, kernels, odf):
            out, counts, info = res
            _sync(dev)
            launches = read_launches()
            set_flags = [k for k, v in info.items() if bool(v.any())]
            if set_flags:
                raise AssertionError(f"{what}: flags set: {set_flags}")
            check_rows(out, counts, build, probe, expected)
            check_same_rows(sorted_rows(out, counts), ref, what)
            wrong = {k: launches[k] for k in kernels if launches[k] != odf}
            if wrong:
                raise AssertionError(f"{what}: each of {kernels} must launch {odf} times: {wrong}")
            return launches

        runs = (("unprepared", 1, dj.XlaCommunicator), ("unprepared", 4, dj.XlaCommunicator),
                ("unprepared_ring", 1, dj.RingCommunicator),
                ("unprepared_buffered", 1, dj.BufferedCommunicator))
        summary = {}
        for path, odf, cls in runs:
            cfg = dj.JoinConfig(over_decom_factor=odf, communicator_cls=cls)

            def join():
                return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)

            reset_launches()
            launches = check(f"process world of 1, {path} odf={odf}", join(),
                             ("join_scans", "expand_values"), odf)
            launch_table.setdefault(path, {})[odf] = launches
            wall, walls, peak = warm_walls(join, reps) if dev.type == "cuda" else (None, [], None)
            summary[f"{path}_odf{odf}"] = {"wall_ms": wall, "wall_ms_runs": walls, "peak_bytes": peak}
            log("process_world_path", smoke_phase="6a", backend=backend, ranks=1, path=path, odf=odf,
                communicator=cls.__name__, rows=rows, total=expected, flags="all False",
                rows_checked=expected, same_rows_as_phase_4=True, launches=launches,
                wall_ms=wall, wall_ms_runs=walls, peak_bytes=peak, card=smi)
        cfg = dj.JoinConfig(key_range=(0, 2 * rows))
        prep = dj.prepare_join_side(topo, right, rcnt, [0], cfg, left_capacity=rows)
        for tier in TIERS:
            os.environ["DJT_JOIN_MERGE"] = tier

            def query():
                return dj.distributed_inner_join(topo, left, lcnt, prep, None, [0], None, cfg)

            reset_launches()
            launches = check(f"process world of 1, prepared tier={tier}", query(),
                             prepared_effective_plan(tier), 1)
            launch_table.setdefault(f"prepared_{tier}", {})[1] = launches
            wall, walls, peak = warm_walls(query, reps) if dev.type == "cuda" else (None, [], None)
            summary[f"prepared_{tier}_odf1"] = {"wall_ms": wall, "wall_ms_runs": walls,
                                                "peak_bytes": peak}
            log("process_world_path", smoke_phase="6a", backend=backend, ranks=1, prepared_tier=tier,
                odf=1, rows=rows, total=expected, flags="all False", rows_checked=expected,
                same_rows_as_phase_4=True, launches=launches, wall_ms=wall, wall_ms_runs=walls,
                peak_bytes=peak, card=smi)
        os.environ.pop("DJT_JOIN_MERGE")
        del prep
        log("process_world_transport", smoke_phase="6a", backend=backend, **check_transport(dj, dev))
        log("process_world", smoke_phase="6a", backend=backend, ranks=1, **summary, card=smi)
    finally:
        os.environ.pop("DJT_JOIN_MERGE", None)
        torch.distributed.destroy_process_group()
    return launch_table


# --- string columns on TPC-H-shaped data (phases 8a-8d) --------------------

# One GPU's split of TPC-H at scale factor 100 split 8 ways, as the
# reference's tpch.cpp gives each GPU one split (scripts/make_tpch_sample.py
# parameters): 150M orders / 8, about 4 lineitems an order, 15M customers / 8.
TPCH_SPLITS = 8
TPCH_ORDERS = 18_750_000
TPCH_LINEITEMS_PER_ORDER = 4.0
CHAR_FIT = 5.0  # char_out_factor of 8a: the lineitems copy each order's priority ~4 times
CHAR_FIT_KEYS = 2.0  # 8c: each customer's segment is copied ~1.25 times
CHAR_FIT_Q3 = 6.0  # 8g: customer's char capacity over its bytes (each segment copied ~5 times)


class PassTimer:
    """Device ms of the string passes inside one call: each wrapped
    function's work is bracketed by CUDA events on the current stream
    (in the in-process world only one rank issues work at a time, so the
    events bracket that call's kernels alone)."""

    def __init__(self):
        from dj_tpu_torch.core import table
        from dj_tpu_torch.ops import hashing, join
        from dj_tpu_torch.parallel import all_to_all

        self.targets = [("string_take", table.StringColumn, "take"),
                        ("string_hash", hashing, "_string_hashes"),
                        ("verify", join, "_verify_string_pairs"),
                        ("char_bucketize", all_to_all, "bucketize"),
                        ("char_compact", all_to_all, "compact")]

    def __enter__(self):
        self.events, self.orig = [], {}
        for label, owner, name in self.targets:
            fn = getattr(owner, name)
            self.orig[(owner, name)] = fn
            setattr(owner, name, self._timed(label, fn))
        return self

    def _timed(self, label, fn):
        def timed(*a, **k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.events.append((label, start, end))
            return out
        return timed

    def __exit__(self, *exc):
        for (owner, name), fn in self.orig.items():
            setattr(owner, name, fn)

    def ms(self) -> dict:
        torch.cuda.synchronize()
        out: dict = {}
        for label, start, end in self.events:
            ms, n = out.get(label, (0.0, 0))
            out[label] = (ms + start.elapsed_time(end), n + 1)
        return {k: {"ms": ms, "calls": n} for k, (ms, n) in out.items()}


def word_codes(col, words) -> torch.Tensor:
    """The index in ``words`` of each string of ``col``, read from its
    first byte (every word of PRIORITIES and SEGMENTS starts with its
    own byte)."""
    table = torch.full((256,), -1, dtype=torch.int64, device=col.device)
    for i, w in enumerate(words):
        table[ord(w[0])] = i
    first = col.chars[col.offsets[:-1].to(torch.int64)].to(torch.int64)
    return table[first]


def check_string_codes(what: str, col, n: int, code: torch.Tensor, words) -> None:
    """Rows [0, n) of ``col`` equal ``words[code]`` byte for byte: the
    expected bytes are built apart from the port's gathers (a
    repeat_interleave of the rows over their sizes)."""
    dev = col.device
    enc = [w.encode() for w in words]
    lens = torch.tensor([len(w) for w in enc], dtype=torch.int64, device=dev)
    flat = torch.frombuffer(bytearray(b"".join(enc)), dtype=torch.uint8).to(dev)
    start = torch.cumsum(lens, 0) - lens
    sizes = col.sizes()[:n].to(torch.int64)
    if not torch.equal(sizes, lens[code]):
        raise AssertionError(f"{what}: a string's length differs from its expected word's")
    offs = col.offsets[: n + 1].to(torch.int64)
    nbytes = int(offs[-1])
    row = torch.repeat_interleave(torch.arange(n, device=dev), sizes, output_size=nbytes)
    want = flat[start[code][row] + torch.arange(nbytes, device=dev) - offs[row]]
    if not torch.equal(col.chars[:nbytes], want):
        raise AssertionError(f"{what}: a string's bytes differ from its expected word's")


def tpch_tables(dj, dev, seed: int, n_orders: int):
    """Split 0 of one GPU's share of TPC-H: (orders, lineitem, customer,
    customers per split), built by the port of make_split on the card."""
    from dj_tpu_torch.data import tpch

    n_cust = n_orders // 10
    t0 = time.perf_counter()
    orders, lineitem, customer = tpch.make_split(0, n_orders, seed, TPCH_LINEITEMS_PER_ORDER,
                                                 n_cust, n_cust * TPCH_SPLITS, device=dev)
    torch.cuda.synchronize()
    log("tpch_data", smoke_phase="8", split=0, splits=TPCH_SPLITS, orders=orders.capacity,
        lineitems=lineitem.capacity, customers=customer.capacity,
        priority_bytes=int(orders.columns[2].offsets[-1]),
        segment_bytes=int(customer.columns[1].offsets[-1]),
        build_seconds=round(time.perf_counter() - t0, 3))
    return orders, lineitem, customer, n_cust


def lineitem_words(keys, partkey, quantity) -> torch.Tensor:
    """Each lineitem row packed into one sortable int64 (orderkey < 2^28,
    partkey < 2^27, quantity < 2^6)."""
    return (keys << 33) | (partkey << 6) | quantity


def check_orders_lineitem(what: str, dj, out, counts, orders, lineitem, li_sorted) -> None:
    """8a's rows: the count is the lineitem count; the lineitem columns
    of the output, as a multiset, are lineitem's; each row's O_CUSTKEY
    and O_ORDERPRIORITY are those its orderkey was drawn with."""
    from dj_tpu_torch.data import tpch

    flat = dj.unshard_table(out, counts) if counts.shape[0] > 1 else out
    n = int(counts.sum())
    if n != lineitem.capacity:
        raise AssertionError(f"{what}: {n} rows, expected the {lineitem.capacity} lineitems")
    ok, ck, pri, pk, q = flat.columns
    got = torch.sort(lineitem_words(ok.data[:n], pk.data[:n], q.data[:n])).values
    if not torch.equal(got, li_sorted):
        raise AssertionError(f"{what}: the lineitem columns differ from lineitem's rows")
    okeys, ocust = orders.columns[0].data, orders.columns[1].data
    base = int(okeys.min())
    row_of = torch.empty_like(okeys)
    row_of[okeys - base] = torch.arange(okeys.shape[0], device=okeys.device)
    rows = row_of[ok.data[:n] - base]
    if not torch.equal(ck.data[:n], ocust[rows]):
        raise AssertionError(f"{what}: an O_CUSTKEY differs from its order's")
    code = word_codes(orders.columns[2], tpch.PRIORITIES)[rows]
    check_string_codes(what, pri, n, code, tpch.PRIORITIES)


def run_strings(dj, dev, seed: int, n_orders: int, smi: str, verifier_rows: int = 1_000_000):
    """Phases 8a-8d (8d on ``verifier_rows`` rows a side). Returns
    ({path: {odf: launches}} of one rank, the same for the 4-rank
    world)."""
    from dj_tpu_torch.data import tpch
    from dj_tpu_torch.ops import hashing
    from dj_tpu_torch.parallel import dist_join as dist
    from dj_tpu_torch.parallel.dist_join import MAIN_JOIN_SEED
    from dj_tpu_torch.resilience import ledger

    t_phase = time.perf_counter()
    orders, lineitem, customer, n_cust = tpch_tables(dj, dev, seed, n_orders)
    li_sorted = torch.sort(lineitem_words(*(c.data for c in lineitem.columns))).values
    launch_table: dict = {}
    world_table: dict = {}

    def joined(what, topo, left, right, cfg, kernels_each):
        """One join, its flags, launches and string passes."""
        reset_launches()
        with PassTimer() as timer:
            res = dj.distributed_inner_join(topo, *left, *right, [0], [0], cfg)
            torch.cuda.synchronize()
        launches = read_launches()
        set_flags = [k for k, v in res[2].items() if bool(v.any())]
        if set_flags:
            raise AssertionError(f"{what}: flags set: {set_flags}")
        wrong = {k: launches[k] for k in ("join_scans", "expand_values")
                 if launches[k] != kernels_each}
        if wrong:
            raise AssertionError(f"{what}: each kernel must launch {kernels_each} times: {wrong}")
        return res, launches, timer.ms()

    # 8a. orders (O_ORDERKEY, O_CUSTKEY, O_ORDERPRIORITY) join lineitem
    # (L_ORDERKEY, L_PARTKEY, L_QUANTITY) on the orderkey
    for w in (1, WORLD):
        topo = dj.make_topology() if w == 1 else dj.make_topology([dev] * WORLD)
        left, right = dj.shard_table(topo, orders), dj.shard_table(topo, lineitem)
        for odf in ((1, 4) if w == 1 else (1,)):
            cfg = dj.JoinConfig(over_decom_factor=odf, char_out_factor=CHAR_FIT)
            what = f"8a world {w} odf {odf}"
            res, launches, passes = joined(what, topo, left, right, cfg, w * odf)
            check_orders_lineitem(what, dj, *res[:2], orders, lineitem, li_sorted)
            (world_table if w > 1 else launch_table).setdefault(
                "tpch_orders_lineitem", {})[odf] = launches
            del res

            def join():
                return dj.distributed_inner_join(topo, *left, *right, [0], [0], cfg)

            wall, runs, peak = warm_walls(join)
            phases = world_phases(join) if w > 1 else None
            log("tpch_join", smoke_phase="8a", ranks=w, odf=odf, key="O_ORDERKEY = L_ORDERKEY",
                string_payload="O_ORDERPRIORITY", char_out_factor=CHAR_FIT,
                total=lineitem.capacity, flags="all False", rows_checked=lineitem.capacity,
                priorities_checked=True, launches=launches, wall_ms=wall, wall_ms_runs=runs,
                peak_bytes=peak, string_pass_ms=passes,
                **({"phases": phases} if phases else {}), card=smi)
            if w == 1 and odf == 1:
                profile_join(join, path="tpch_orders_lineitem", odf=odf)
        del left, right, topo
        torch.cuda.empty_cache()

    # 8b. the char_overflow heal at the default char_out_factor 1.0; the
    # second call of the shape starts from the ledger
    topo = dj.make_topology()
    left, right = dj.shard_table(topo, orders), dj.shard_table(topo, lineitem)
    ledger.reset()
    for call in ("first", "second"):
        reset_launches()
        with Attempts() as a:
            t0 = time.perf_counter()
            res = dj.distributed_inner_join_auto(topo, *left, *right, [0], [0])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        set_flags = [k for k, v in res[2].items() if bool(v.any())]
        if set_flags:
            raise AssertionError(f"8b {call}: flags set after healing: {set_flags}")
        check_orders_lineitem(f"8b {call}", dj, *res[:2], orders, lineitem, li_sorted)
        factor = res[3].char_out_factor
        if call == "first" and (a.n < 2 or factor <= 1.0):
            raise AssertionError(f"8b: no char_overflow heal ({a.n} attempts, factor {factor})")
        if call == "second" and a.n != 1:
            raise AssertionError(f"8b: the ledger's second call took {a.n} attempts")
        launch_table[f"tpch_auto_{call}"] = {1: read_launches()}
        log("tpch_auto", smoke_phase="8b", call=call, attempts=a.n, char_out_factor_from=1.0,
            char_out_factor_used=factor, total=lineitem.capacity, flags="all False",
            priorities_checked=True, wall_ms=wall, launches=launch_table[f"tpch_auto_{call}"][1],
            card=smi)
        del res
    ledger.reset()
    del left, right
    torch.cuda.empty_cache()

    # 8c. customer keyed by C_NAME join orders keyed by the C_NAME of
    # O_CUSTKEY, C_MKTSEGMENT the string payload
    okey, ocust = orders.columns[0].data, orders.columns[1].data
    ckey, cseg = customer.columns
    o_side = dj.Table((tpch.customer_names(ocust), orders.columns[0], orders.columns[1]))
    c_side = dj.Table((tpch.customer_names(ckey.data), cseg, ckey))
    hit = ocust < n_cust  # split 0's customers are [0, n_cust)
    expected = int(hit.sum())
    want_orders = torch.sort(okey[hit]).values
    seg_code = torch.empty(n_cust, dtype=torch.int64, device=dev)
    seg_code[ckey.data] = word_codes(cseg, tpch.SEGMENTS)
    del hit
    def check_string_key(what, res, w, colocated):
        """8c's checks of one result: the host's count, each row joining
        one customer, the orders joined, each row's C_NAME key and
        segment byte for byte, and with ``colocated`` each row on its
        key's shard."""
        out, counts, info = res
        if colocated:
            cap, ocap = out.capacity // w, out.columns[0].chars.shape[0] // w
            for r, n in enumerate(counts.tolist()):
                name = dj.StringColumn(out.columns[0].offsets[r * (cap + 1):(r + 1) * (cap + 1)],
                                       out.columns[0].chars[r * ocap:(r + 1) * ocap])
                h = hashing._string_hash(name, MAIN_JOIN_SEED)[:n]
                if not bool((h % w == r).all()):
                    raise AssertionError(f"{what}: a row on shard {r} hashes to another rank")
        flat = dj.unshard_table(out, counts) if w > 1 else out
        n = int(counts.sum())
        if n != expected:
            raise AssertionError(f"{what}: {n} rows, expected {expected}")
        name, ok, oc, seg, cc = flat.columns
        if not torch.equal(oc.data[:n], cc.data[:n]):
            raise AssertionError(f"{what}: a row joins two customers")
        if not torch.equal(torch.sort(ok.data[:n]).values, want_orders):
            raise AssertionError(f"{what}: the orders joined differ from the host's")
        names = tpch.customer_names(oc.data[:n])
        if not (torch.equal(name.offsets[: n + 1], names.offsets)
                and torch.equal(name.chars[: 18 * n], names.chars[: 18 * n])):
            raise AssertionError(f"{what}: an order's C_NAME key differs from its O_CUSTKEY's")
        check_string_codes(what, seg, n, seg_code[cc.data[:n]], tpch.SEGMENTS)

    for w in (1, WORLD):
        topo = dj.make_topology() if w == 1 else dj.make_topology([dev] * WORLD)
        left, right = dj.shard_table(topo, o_side), dj.shard_table(topo, c_side)
        cfg = dj.JoinConfig(char_out_factor=CHAR_FIT_KEYS)
        what = f"8c world {w}"
        res, launches, passes = joined(what, topo, left, right, cfg, w)
        check_string_key(what, res, w, colocated=w > 1)
        (world_table if w > 1 else launch_table).setdefault("tpch_string_key", {})[1] = launches
        del res

        def join():
            return dj.distributed_inner_join(topo, *left, *right, [0], [0], cfg)

        wall, runs, peak = warm_walls(join)
        log("tpch_string_key", smoke_phase="8c", ranks=w, odf=1, key="C_NAME", key_bytes=18,
            string_payload="C_MKTSEGMENT", char_out_factor=CHAR_FIT_KEYS, total=expected,
            host_count=expected, flags="all False", surrogate_collision=False,
            colocated=w > 1, launches=launches, wall_ms=wall, wall_ms_runs=runs,
            peak_bytes=peak, string_pass_ms=passes, card=smi)
        if w == 1:
            del left, right, topo
        torch.cuda.empty_cache()

    # 8f. 8c's world join under DJT_PLAN_ADAPT=1: customer, the build side,
    # is broadcast to every rank, each string column as two buffers.
    ledger.reset()
    with env_set(DJT_PLAN_ADAPT="1"):
        d = dist._resolve_plan_decision(topo, *left, *right, (0,), (0,), cfg)
        if (d.tier, d.source) != ("broadcast", "fit"):
            raise AssertionError(f"8f: decision {d}")
        with Collectives() as coll:
            res, launches, bc_passes = joined("8f broadcast", topo, left, right, cfg, WORLD)
        if coll.counts["all_to_all_start"] or coll.counts["shift_start"]:
            raise AssertionError(f"8f: the join issued an all-to-all: {coll.counts}")
        check_string_key("8f broadcast", res, WORLD, colocated=False)
        world_table.setdefault("tpch_string_key_broadcast", {})[1] = launches
        del res
        bc_wall, bc_runs, bc_peak = warm_walls(join)
        bc_phases = world_phases(join)
    ledger.reset()
    log("tpch_string_key", smoke_phase="8f", ranks=WORLD, odf=1, tier=d.tier, source=d.source,
        key="C_NAME", string_payload="C_MKTSEGMENT", char_out_factor=CHAR_FIT_KEYS,
        total=expected, flags="all False", surrogate_collision=False, collectives=coll.counts,
        launches=launches, wall_ms=bc_wall, wall_ms_runs=bc_runs, peak_bytes=bc_peak,
        shuffle_plan_wall_ms=wall, shuffle_plan_peak_bytes=peak, string_pass_ms=bc_passes,
        shuffle_plan_string_pass_ms=passes, phases=bc_phases, card=smi)
    del left, right, topo
    torch.cuda.empty_cache()
    del o_side, c_side, want_orders, seg_code

    # 8d. the verifier on the card: a surrogate weakened to ignore each
    # string's first byte, so "Customer#k" and "Dustomer#k" collide
    real = hashing.string_surrogate64

    def weak(col, max_len=hashing.SURROGATE_MAX_LEN):
        chars = col.chars.clone()
        nonempty = col.sizes() > 0
        chars[col.offsets[:-1][nonempty].to(torch.int64)] = ord("C")
        return real(dj.StringColumn(col.offsets, chars), max_len)

    m = verifier_rows
    names = tpch.customer_names(torch.arange(m, device=dev))
    other = dj.StringColumn(names.offsets, names.chars.clone())
    other.chars[other.offsets[:-1].to(torch.int64)] = ord("D")
    perm = torch.randperm(m, device=dev)
    ids = torch.arange(m, device=dev)
    shuffled = names.take(perm)
    topo = dj.make_topology()
    cases = {"forced_collision": (names, other, ids), "true_match": (names, shuffled, perm)}
    hashing.string_surrogate64 = weak
    try:
        for case, (lcol, rcol, rid) in cases.items():
            left = dj.shard_table(topo, dj.Table((lcol, dj.Column(ids, dj.dtypes.int64))))
            right = dj.shard_table(topo, dj.Table((rcol, dj.Column(rid, dj.dtypes.int64))))
            reset_launches()
            out, counts, info = dj.distributed_inner_join(topo, *left, *right, [0], [0])
            torch.cuda.synchronize()
            launches = read_launches()
            flagged = bool(info["surrogate_collision"].any())
            n = int(counts.sum())
            if n != m or flagged != (case == "forced_collision"):
                raise AssertionError(f"8d {case}: {n} rows, surrogate_collision {flagged}")
            if not torch.equal(out.columns[1].data[:n], out.columns[2].data[:n]):
                raise AssertionError(f"8d {case}: a row pairs two different ids")
            outcome = "not run"
            if case == "forced_collision":
                with Attempts() as a:
                    try:
                        dj.distributed_inner_join_auto(topo, *left, *right, [0], [0])
                    except RuntimeError as e:
                        if "surrogate_collision" not in str(e) or a.n != 1:
                            raise AssertionError(f"8d: auto raised {e!r} after {a.n} attempts")
                        outcome = f"raised after {a.n} attempt: {e}"
                    else:
                        raise AssertionError("8d: the auto wrapper healed a collision")
            log("tpch_verifier", smoke_phase="8d", case=case, rows=m, total=n,
                surrogate_collision=flagged, auto=outcome, launches=launches, card=smi)
            del out, counts, info, left, right
    finally:
        hashing.string_surrogate64 = real
    del names, other, shuffled, perm, ids, orders, lineitem, customer, li_sorted
    torch.cuda.empty_cache()
    log("tpch_phase", smoke_phase="8", seconds=round(time.perf_counter() - t_phase, 3))
    return launch_table, world_table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000_000,
                    help="build and probe rows of the main path (default 100M)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--orders", type=int, default=TPCH_ORDERS,
                    help="orders of phase 8's TPC-H split (default one GPU's share of SF 100)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 1
    import dj_tpu_torch as dj
    from dj_tpu_torch.ops import cuda_build
    from dj_tpu_torch.ops.join import (
        EXPAND_KERNELS,
        _anchored_pack_word,
        _probe_counts,
        plan_prepared_pack,
        prepare_packed_batch,
        prepared_effective_plan,
    )
    from dj_tpu_torch.ops.merge import sort_u64
    from dj_tpu_torch.parallel.dist_join import _prepared_query_sizing, batch_sizing

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    log("device", name=torch.cuda.get_device_name(0), torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())

    # 2. build
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    for name in libs:
        cuda_build.load(name)
    log("build", seconds=round(time.perf_counter() - t0, 3), kernels=sorted(libs))

    # 3. kernels vs plain
    rows = args.rows
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    build, probe, expected = dj.generate_build_probe_tables(
        gen, rows, rows, 0.3, 2 * rows, True, return_expected_matches=True
    )
    expected = int(expected)
    sp, lc, rc, tb, L, R = packed_inputs(build, probe, dev)
    out_cap = batch_sizing(dj.JoinConfig(), 1, rows, rows).out_cap
    scan_err, exp_err, timing = compare_kernels("main_path", sp, lc, rc, tb, L, R, out_cap, timing=True)
    del sp
    errs = [(scan_err, exp_err)]

    # (b) one hot key, 5e7, on 1M build rows and 3 probe rows, among
    # random keys in [0, 1e8) (about one probe row in 100 matches). A
    # build row's csum adds nothing, so the block whose slots hold the
    # hot key's csum (the sparse matches before it) spans its 1M refs,
    # and the sparse region's blocks span ~1e5 positions each: both far
    # past the shared-memory window, so the kernel searches global
    # memory there; the hot queries' blocks (1M slots each) stay staged.
    # Total stays below 2^31 and n_out above it, so every slot is compared.
    sk = 1_000_000
    hot_key = 50_000_000
    b_keys = torch.cat([torch.full((sk,), hot_key, dtype=torch.int64, device=dev),
                        torch.randint(0, 10**8, (sk + 12_345,), generator=gen, device=dev)])
    p_keys = torch.cat([torch.full((3,), hot_key, dtype=torch.int64, device=dev),
                        torch.randint(0, 10**8, (3 * sk + 777,), generator=gen, device=dev)])
    args_b = packed_inputs(dj.Table((dj.Column(b_keys, dj.dtypes.int64),)),
                           dj.Table((dj.Column(p_keys, dj.dtypes.int64),)), dev)
    errs.append(compare_kernels("skewed", *args_b, n_out=4 * sk, timing=False,
                                need_global_windows=True))
    # Two calls in a row on one input: statuses or a tile counter left
    # from the last call would give wrong carries.
    scan_errs = [compare_scans("skewed_two_calls_in_a_row", *args_b, calls=2)[1]]
    del args_b, b_keys, p_keys
    # (b2) sparse matches at selectivity 0.001: ~2000 merged positions
    # per match, so every block below total searches global memory.
    sb, spr = dj.generate_build_probe_tables(gen, 10 * sk, 10 * sk, 0.001, 20 * sk, True)
    args_s = packed_inputs(sb, spr, dev)
    errs.append(compare_kernels("sparse_sel_0.001", *args_s, n_out=10 * sk, timing=False,
                                need_global_windows=True))
    del args_s, sb, spr
    # (b3) one key on 1M build and 1M probe rows: 1e12 matches, so csum
    # wraps; join_scans must still equal its plain version bit for bit.
    hot = torch.full((sk,), 7, dtype=torch.int64, device=dev)
    args_h = packed_inputs(dj.Table((dj.Column(hot, dj.dtypes.int64),)),
                           dj.Table((dj.Column(hot.clone(), dj.dtypes.int64),)), dev)
    errs.append(compare_kernels("skewed_1Mx1M_csum_wraps", *args_h, n_out=sk, timing=False))
    del args_h, hot

    # (c) all miss: even build keys, odd probe keys.
    mb = torch.arange(0, 2 * 1_000_003, 2, dtype=torch.int64, device=dev)
    mp = torch.arange(1, 2 * 999_999, 2, dtype=torch.int64, device=dev)
    miss = packed_inputs(dj.Table((dj.Column(mb, dj.dtypes.int64),)),
                         dj.Table((dj.Column(mp, dj.dtypes.int64),)), dev)
    errs.append(compare_kernels("all_miss", *miss, n_out=2_000_000, timing=False))
    del miss, mb, mp

    # (d) look-back edge cases: S one scan tile + 1, one tile, one tile
    # - 1, 31 and 1, each right after a call on a larger S (stale scratch
    # would show), keys in [0, 8) so runs cross threads and tiles.
    def small_keys(n):
        return dj.Table((dj.Column(torch.randint(0, 8, (n,), generator=gen, device=dev),
                                   dj.dtypes.int64),))

    from dj_tpu_torch.ops.scan import TILE as ST
    for S_small, n_build in ((ST + 1, 1), (ST, ST // 2), (ST - 1, ST // 2), (31, 15), (1, 1)):
        small = packed_inputs(small_keys(n_build), small_keys(S_small - n_build), dev)
        scan_errs.append(compare_scans(f"S_{S_small}", *small)[1])
    del small
    torch.cuda.empty_cache()

    # 4. unprepared path through the user's entry points
    topo = dj.make_topology()
    left, lcnt = dj.shard_table(topo, probe)
    right, rcnt = dj.shard_table(topo, build)
    launch_table = {"unprepared": {}}
    walls = {}
    peaks = {}
    ref = None
    for odf in (1, 4):
        cfg = dj.JoinConfig(over_decom_factor=odf)
        reset_launches()
        out, counts, info = dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)
        torch.cuda.synchronize()
        launches = read_launches()
        set_flags = [k for k, v in info.items() if bool(v.any())]
        if set_flags:
            raise AssertionError(f"odf={odf}: flags set: {set_flags}")
        check_rows(out, counts, build, probe, expected)
        if min(launches["join_scans"], launches["expand_values"]) < 1:
            raise AssertionError(f"odf={odf}: a kernel was not launched: {launches}")
        launch_table["unprepared"][odf] = launches
        if ref is None:
            ref = sorted_rows(out, counts)
        del out, counts, info
        runs = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            t0 = time.perf_counter()
            res = dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
            del res
        walls[odf] = statistics.median(runs)
        peaks[odf] = torch.cuda.max_memory_allocated()
        log("main_path", odf=odf, rows=rows, total=expected, flags="all False",
            rows_checked=expected, launches=launches, wall_ms=walls[odf],
            wall_ms_runs=runs, peak_bytes=peaks[odf])
        profile_join(lambda: dj.distributed_inner_join(
            topo, left, lcnt, right, rcnt, [0], [0], cfg), path="unprepared", odf=odf)

    # 4b. the unprepared path under each other expansion mode
    mode_walls, mode_peaks = {}, {}
    for mode in MODES:
        os.environ["DJT_JOIN_EXPAND"] = mode
        kernel = EXPAND_KERNELS[mode]
        for odf in (1, 4):
            cfg = dj.JoinConfig(over_decom_factor=odf)

            def join():
                return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)

            what = f"mode={mode} odf={odf}"
            reset_launches()
            out, counts, info = join()
            torch.cuda.synchronize()
            launches = read_launches()
            set_flags = [k for k, v in info.items() if bool(v.any())]
            if set_flags:
                raise AssertionError(f"{what}: flags set: {set_flags}")
            check_rows(out, counts, build, probe, expected)
            check_same_rows(sorted_rows(out, counts), ref, what)
            if min(launches["join_scans"], launches[kernel]) < 1:
                raise AssertionError(f"{what}: {kernel} or join_scans not launched by the join: {launches}")
            launch_table.setdefault(f"unprepared_{mode}", {})[odf] = launches
            del out, counts, info
            runs = []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(3):
                t0 = time.perf_counter()
                res = join()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
                del res
            mode_walls[(mode, odf)] = statistics.median(runs)
            mode_peaks[(mode, odf)] = torch.cuda.max_memory_allocated()
            log("mode_path", mode=mode, odf=odf, rows=rows, total=expected, flags="all False",
                rows_checked=expected, same_rows_as_vmeta=True, launches=launches,
                wall_ms=mode_walls[(mode, odf)], wall_ms_runs=runs,
                peak_bytes=mode_peaks[(mode, odf)])
            if odf == 1:
                profile_join(join, path=f"unprepared_{mode}", odf=odf)
    os.environ.pop("DJT_JOIN_EXPAND")

    # 4c. the mode kernels against their plain versions
    main_in = carry_inputs(build, probe, dev)
    mode_errs, mode_timing = compare_modes("main_path", main_in, out_cap, timing=True)
    mode_errs = [mode_errs, compare_modes("main_path_n_out_below_total", main_in,
                                          int(main_in[1].sum()) // 2)]
    del main_in
    torch.cuda.empty_cache()

    def keyed_table(keys, n_pay):
        """keys plus n_pay payload columns: full-range int64 bits, and
        int32 ones with negative values (zero-extended in the slots)."""
        n = keys.numel()
        cols = [dj.Column(keys, dj.dtypes.int64)]
        for p in range(n_pay):
            if p % 2:
                pay = torch.randint(-(2**31), 2**31 - 1, (n,), generator=gen, device=dev,
                                    dtype=torch.int32)
                cols.append(dj.Column(pay, dj.dtypes.int32))
            else:
                hi = torch.randint(-(2**31), 2**31, (n,), generator=gen, device=dev)
                lo = torch.randint(0, 2**32, (n,), generator=gen, device=dev)
                pay = hi * 2**32 + lo
                cols.append(dj.Column(pay, dj.dtypes.int64))
        return dj.Table(tuple(cols))

    # The hot key of phase 3 (b): 1M refs, whose matches sit up to 1M
    # merged positions below their queries, amid sparse matches.
    b_keys = torch.cat([torch.full((sk,), hot_key, dtype=torch.int64, device=dev),
                        torch.randint(0, 10**8, (sk + 12_345,), generator=gen, device=dev)])
    p_keys = torch.cat([torch.full((3,), hot_key, dtype=torch.int64, device=dev),
                        torch.randint(0, 10**8, (3 * sk + 777,), generator=gen, device=dev)])
    mode_errs.append(compare_modes("skewed_hot_key_1M_refs",
                                   carry_inputs(keyed_table(b_keys, 3), keyed_table(p_keys, 3), dev),
                                   4 * sk, need_global_windows=True, min_ref_distance=sk))
    del b_keys, p_keys
    sb, spr = dj.generate_build_probe_tables(gen, 10 * sk, 10 * sk, 0.001, 20 * sk, True)
    mode_errs.append(compare_modes(
        "sparse_sel_0.001", carry_inputs(keyed_table(sb.columns[0].data, 2),
                                         keyed_table(spr.columns[0].data, 2), dev),
        10 * sk, need_global_windows=True))
    del sb, spr
    mb = torch.arange(0, 2 * 1_000_003, 2, dtype=torch.int64, device=dev)
    mp = torch.arange(1, 2 * 999_999, 2, dtype=torch.int64, device=dev)
    mode_errs.append(compare_modes("all_miss_no_payload",
                                   carry_inputs(keyed_table(mb, 0), keyed_table(mp, 0), dev),
                                   2_000_000))
    del mb, mp
    hot = torch.full((sk,), 7, dtype=torch.int64, device=dev)
    mode_errs.append(compare_modes("skewed_1Mx1M_csum_wraps",
                                   carry_inputs(keyed_table(hot, 1), keyed_table(hot.clone(), 1), dev),
                                   sk))
    del hot
    torch.cuda.empty_cache()

    # 4h. the join's plan knobs
    launch_table.update(run_knobs(dj, topo, left, lcnt, right, rcnt, build, probe, expected, ref,
                                  walls, smi))
    torch.cuda.empty_cache()

    # 4d. the main path over a 4-rank world on this card
    world_launches, world_digests = run_world(dj, dev, build, probe, expected, ref, rows, smi)
    torch.cuda.empty_cache()

    # 4e. the same 4 ranks as 2 domains of 2; 4f. shuffle_on
    two_level_launches, two_level_digests = run_two_level(dj, dev, build, probe, expected, ref,
                                                          rows, smi)
    torch.cuda.empty_cache()
    shuffle_digests = run_shuffle_on(dj, dev, rows, args.seed, smi)
    torch.cuda.empty_cache()

    # 4g. the cascaded codec alone; 4e and 4f again, compressed
    codec = check_codec(dev, 4, min(rows // 100, 1_000_000), args.seed, smi,
                        time_rows=2 * rows // (WORLD * WORLD))
    torch.cuda.empty_cache()
    two_level_launches.update(run_two_level_compressed(dj, dev, build, probe, expected, ref,
                                                       rows, smi))
    torch.cuda.empty_cache()
    run_shuffle_on_compressed(dj, dev, rows, args.seed, smi, shuffle_digests)
    torch.cuda.empty_cache()

    # 4i. the unprepared plan tiers (broadcast, salted) in 4d's world
    plan_launches, plan_digests = run_plan_tiers(dj, dev, build, probe, expected, ref, rows, smi,
                                                 two_level_digests)
    world_launches.update(plan_launches)
    torch.cuda.empty_cache()

    # The warmups; 4j. a two-stage chain with a local stage in 4d's world;
    # 4k. the coalesced unprepared dispatch with shape buckets
    run_warmups(dj, dev, smi)
    world_launches.update(run_pipeline_chain(dj, dev, build, probe, expected, ref, rows, smi))
    torch.cuda.empty_cache()
    world_launches.update(run_coalesced_bucketed(dj, dev, build, probe, rows, smi))
    torch.cuda.empty_cache()

    # 5. prepared path: prepare once, query under each merge tier
    prep_walls, query_walls = {}, {}
    for odf in (1, 4):
        cfg = dj.JoinConfig(over_decom_factor=odf, key_range=(0, 2 * rows))
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(4):  # the first warms up, the next three are timed
            prep = None  # free the previous side before building the next
            t0 = time.perf_counter()
            prep = dj.prepare_join_side(topo, right, rcnt, [0], cfg, left_capacity=rows)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        prep_walls[odf] = statistics.median(runs[1:])
        log("prepare", odf=odf, rows=rows, wall_ms=prep_walls[odf], wall_ms_runs=runs,
            peak_bytes=torch.cuda.max_memory_allocated(), tag_bits=prep.plan.tag_bits,
            resident_rows_per_batch=prep.batches[0][0].shape[0])
        for tier in TIERS:
            os.environ["DJT_JOIN_MERGE"] = tier

            def query():
                return dj.distributed_inner_join(topo, left, lcnt, prep, None, [0], None, cfg)

            reset_launches()
            out, counts, info = query()
            torch.cuda.synchronize()
            launches = read_launches()
            what = f"prepared odf={odf} tier={tier}"
            set_flags = [k for k, v in info.items() if bool(v.any())]
            if set_flags:
                raise AssertionError(f"{what}: flags set: {set_flags}")
            check_rows(out, counts, build, probe, expected)
            check_same_rows(sorted_rows(out, counts), ref, what)
            missing = [k for k in prepared_effective_plan(tier) if launches[k] < 1]
            if missing:
                raise AssertionError(f"{what}: kernels not launched by the query: {missing} ({launches})")
            launch_table.setdefault(f"prepared_{tier}", {})[odf] = launches
            del out, counts, info
            runs = []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(3):
                t0 = time.perf_counter()
                res = query()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
                del res
            query_walls[(odf, tier)] = statistics.median(runs)
            log("prepared_path", odf=odf, tier=tier, rows=rows, total=expected,
                flags="all False", rows_checked=expected, same_rows_as_unprepared=True,
                launches=launches, wall_ms=query_walls[(odf, tier)], wall_ms_runs=runs,
                peak_bytes=torch.cuda.max_memory_allocated())
            if odf == 1:
                profile_join(query, path=f"prepared_{tier}", odf=odf)
        os.environ.pop("DJT_JOIN_MERGE")
        # 5d. the probe tier under each DJT_PROBE_EXPAND mode
        for path, by_odf in run_probe_expand(dj, topo, left, lcnt, prep, cfg, odf, build, probe,
                                             expected, ref, smi).items():
            launch_table.setdefault(path, {}).update(by_odf)
        if odf == 1:
            # 6. the prepared path's kernels on its own inputs
            out_cap = _prepared_query_sizing(topo, cfg, rows, prep)[3]
            pwords, w_l, csum = probe_tier_inputs(prep, left, lcnt)
            merge_err, merge_timing = compare_merge("main_path", pwords, sort_u64(w_l), timing=True)
            del w_l
            ranks_err, ranks_timing = compare_ranks("main_path", csum, out_cap, timing=True)
            # 5d. expand_values as the probe tier runs it, on the same inputs
            cnt = torch.diff(csum, prepend=torch.zeros(1, dtype=csum.dtype, device=dev))
            probe_err, probe_timing = compare_probe_values("probe_tier_main_path", cnt, out_cap,
                                                           timing=True)
            del pwords, csum, cnt
        del prep
        torch.cuda.empty_cache()

    # 5d. expand_values on the probe tier's edge cases
    probe_errs = [probe_err] + probe_values_edge_cases(gen, dev, 1_000_000)
    torch.cuda.empty_cache()

    # 5c. appends to the prepared side
    append_launches, append_world = run_appends(dj, dev, gen, topo, left, lcnt, right, rcnt, build,
                                                probe, expected, rows, smi)
    launch_table.update(append_launches)
    torch.cuda.empty_cache()

    # 5e. the broadcast- and salted-prepared build sides in 4d's world
    world_launches.update(run_prepared_tiers(dj, dev, gen, topo, left, lcnt, build, probe,
                                             expected, ref, rows, smi))
    torch.cuda.empty_cache()

    # 5f. the coalesced prepared dispatch in 4d's world
    world_launches.update(run_coalesced_prepared(dj, dev, gen, build, probe, expected, ref, rows,
                                                 smi))
    torch.cuda.empty_cache()

    # 5b. unsigned keys and payloads
    check_unsigned_path(dj, topo, gen, dev, min(rows, 1_000_000))
    torch.cuda.empty_cache()

    # 7a-7c. every fixed-width key kind, float keys' special values, and
    # distributed_inner_join_auto
    launch_table.update(run_key_kinds(dj, topo, build, probe, expected, ref, smi))
    launch_table.update(check_float_specials(dj, gen, dev, min(rows, 1_000_000), smi))
    launch_table.update(check_auto(dj, dev, topo, left, lcnt, right, rcnt, build, probe, expected,
                                   ref, rows, smi))
    torch.cuda.empty_cache()

    # 8a-8d. string columns on one GPU's split of TPC-H at scale factor 100
    tpch_launches, tpch_world = run_strings(dj, dev, args.seed, args.orders, smi)
    launch_table.update(tpch_launches)
    world_launches.update(tpch_world)
    world_launches.update(append_world)

    # 8e. the prepared side with string columns, on phase 8's split
    orders, lineitem, customer, n_cust = tpch_tables(dj, dev, args.seed, args.orders)
    li_sorted = torch.sort(lineitem_words(*(c.data for c in lineitem.columns))).values
    tpch_launches, tpch_world = run_prepared_strings(dj, dev, orders, lineitem, li_sorted, smi)
    launch_table.update(tpch_launches)
    world_launches.update(tpch_world)
    del li_sorted
    torch.cuda.empty_cache()

    # 8g. TPC-H Q3's joins as one pipeline, on phase 8's split
    tpch_launches, tpch_world = run_q3_pipeline(dj, dev, orders, lineitem, customer, n_cust, smi)
    launch_table.update(tpch_launches)
    world_launches.update(tpch_world)
    del orders, lineitem, customer
    torch.cuda.empty_cache()

    # 6a. a process world of one over NCCL
    process1_launches = process_world_of_one(dj, dev, "nccl", build, probe, expected, ref, rows, smi)
    del ref
    torch.cuda.empty_cache()
    first_join_with_warmup(dj, dev, "nccl", build, probe, smi)
    torch.cuda.empty_cache()
    chain_rows = min(CHAIN_ROWS, rows)
    chain_want = chain_in_one_process(dj, dev, chain_rows, args.seed)
    torch.cuda.empty_cache()

    # 6b. four processes on this card over gloo, phase 4d's blocks, then
    # the same processes as 2 domains of 2 (4e's join, 4f's shuffle)
    t_6b = time.perf_counter()
    parent_bytes = torch.cuda.memory_reserved()
    process4 = run_process_world(WORLD, "gloo", "cuda", rows, args.seed, intra=INTRA,
                                 shuffle_rows=rows, broadcast=True, chain_rows=chain_rows)
    check_process_world("6b", process4, world_digests, expected, 1)
    check_broadcast_processes("6b", process4, plan_digests, expected, 1)
    check_two_level_processes("6b", process4, two_level_digests, shuffle_digests, expected, 1)
    check_chain_processes("6b", process4, chain_want)
    log("process_world_chain", smoke_phase="6b", backend="gloo", ranks=WORLD, odf=1,
        rows=chain_rows, plan=chain_want["plan"], plans_equal=True, flags="all False",
        digests=[res["chain"]["digest"] for res in process4], digests_equal_one_process=True,
        launches_by_rank=[res["chain"]["launches"] for res in process4], card=smi)
    log("process_world", smoke_phase="6b", backend="gloo", ranks=WORLD, device=str(dev),
        transport=process4[0]["transport"], host_staged_calls=process4[0]["host_staged_calls"],
        rows_per_rank=rows // WORLD, odf=1, flags="all False", total=expected,
        digests=[res["digest"] for res in process4], digests_equal_phase_4d=True,
        wall_ms_by_rank=[res["wall_ms"] for res in process4],
        wall_ms_runs_by_rank=[res["wall_ms_runs"] for res in process4],
        exchange_ms_by_rank=[res["phase_ms"].get("a2a_exchange") for res in process4],
        phase_ms_by_rank=[res["phase_ms"] for res in process4],
        peak_bytes_by_rank=[res["peak_bytes"] for res in process4],
        launches_by_rank=[res["launches"] for res in process4], card=smi)
    log("process_world_broadcast", smoke_phase="6b", backend="gloo", ranks=WORLD, odf=1,
        decision=process4[0]["broadcast"]["decision"], decisions_equal=True, flags="all False",
        digests=[res["broadcast"]["digest"] for res in process4], digests_equal_phase_4i=True,
        wall_ms_by_rank=[res["broadcast"]["wall_ms"] for res in process4],
        peak_bytes_by_rank=[res["broadcast"].get("peak_bytes") for res in process4],
        launches_by_rank=[res["broadcast"]["launches"] for res in process4], card=smi)
    two = [res["two_level"] for res in process4]
    log("process_world_two_level", smoke_phase="6b", backend="gloo", ranks=WORLD, intra=INTRA,
        axes=two[0]["axes"], groups=two[0]["groups"], odf=1, flags="all False",
        digests=[t["digest"] for t in two], digests_equal_phase_4e=True,
        shuffle_digests=[t["shuffle_digest"] for t in two], shuffle_digests_equal_phase_4f=True,
        wall_ms_by_rank=[t["wall_ms"] for t in two],
        pre_shuffle_ms_by_rank=[pre_shuffle_ms(t["phase_ms"]) for t in two],
        phase_ms_by_rank=[t["phase_ms"] for t in two],
        shuffle_wall_ms_by_rank=[t["shuffle_wall_ms"] for t in two],
        launches_by_rank=[t["launches"] for t in two], seconds=time.perf_counter() - t_6b,
        parent_reserved_bytes=parent_bytes, card=smi)
    log("process_world_compressed", smoke_phase="6b", backend="gloo", ranks=WORLD,
        intra=INTRA, options_agreed_rank0=True,
        options_local_by_rank=[t["options_local"] for t in two],
        inter_digests_equal_raw=True,
        inter_exchange_ms_raw_by_rank=[t["inter_raw"]["exchange_ms"] for t in two],
        inter_exchange_ms_compressed_by_rank=[t["inter_compressed"]["exchange_ms"]
                                              for t in two],
        inter_wall_ms_raw_by_rank=[t["inter_raw"]["wall_ms"] for t in two],
        inter_wall_ms_compressed_by_rank=[t["inter_compressed"]["wall_ms"] for t in two],
        inter_phase_ms_compressed_by_rank=[t["inter_compressed"]["phase_ms"] for t in two],
        comp=[{k: sum(v) for k, v in t["inter_compressed"]["stats"].items()} for t in two][0],
        card=smi)

    # 6c. an NCCL world of one process per card, phase 4d's rows a rank,
    # at 4e's intra size when the cards factor by it
    cards = torch.cuda.device_count()
    process_n = None
    intra_n = INTRA if cards > INTRA and cards % INTRA == 0 else None
    if cards >= 2:
        process_n = run_process_world(cards, "nccl", "cuda", cards * (rows // WORLD), args.seed,
                                      local_ranks=True, intra=intra_n,
                                      shuffle_rows=cards * (rows // WORLD) if intra_n else 0)
        check_process_world("6c", process_n, world_digests if cards == WORLD else None,
                            process_n[0]["expected"], 1)
        if intra_n:
            check_two_level_processes("6c", process_n,
                                      two_level_digests if cards == WORLD else None,
                                      shuffle_digests if cards == WORLD else None,
                                      process_n[0]["expected"], 1)
        log("process_world", smoke_phase="6c", backend="nccl", ranks=cards,
            transport=process_n[0]["transport"], rows_per_rank=rows // WORLD, odf=1,
            flags="all False", total=process_n[0]["expected"],
            digests=[res["digest"] for res in process_n],
            wall_ms_by_rank=[res["wall_ms"] for res in process_n],
            exchange_ms_by_rank=[res["phase_ms"].get("a2a_exchange") for res in process_n],
            phase_ms_by_rank=[res["phase_ms"] for res in process_n],
            peak_bytes_by_rank=[res["peak_bytes"] for res in process_n], card=smi)
    else:
        log("process_world", smoke_phase="6c", started=False,
            why=f"this machine has {cards} card; an NCCL world of one process per card needs "
                f"2 or more (NCCL refuses two ranks on one GPU), and its two-level half "
                f"(intra {INTRA}, NCCL subgroups) {2 * INTRA} or more")

    # 6. the prepared path's kernels on edge cases
    merge_errs, ranks_errs = [merge_err], [ranks_err]

    def sorted_words(n, lo, hi, sentinels=0):
        x = torch.randint(lo, hi, (n,), generator=gen, device=dev)
        if sentinels:
            x[-sentinels:] = -1  # the all-ones padding
        return sort_u64(x)

    merge_errs.append(compare_merge("cross_duplicates_sentinel_tails",
                                    sorted_words(3_000_000, 0, 50, 1_000_000),
                                    sorted_words(2_000_017, 0, 50, 333)))
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    merge_errs.append(compare_merge("empty_a", empty, sorted_words(1000, 0, 2**62)))
    merge_errs.append(compare_merge("empty_b", sorted_words(1000, 0, 2**62), empty))
    merge_errs.append(compare_merge("length_one", torch.tensor([-5], device=dev),
                                    torch.tensor([7], device=dev)))
    merge_errs.append(compare_merge("lengths_off_tile", sorted_words(4097, 0, 2**62),
                                    sorted_words(12_345, 0, 2**62)))
    # Negative int64 words have the top bit set: as u64 all lie above b.
    merge_errs.append(compare_merge("a_wholly_above_b", sorted_words(300_001, -(2**62), -1),
                                    sorted_words(700_003, 0, 2**62)))

    sk = 1_000_000
    sb, spr = dj.generate_build_probe_tables(gen, 10 * sk, 10 * sk, 0.001, 20 * sk, True)
    splan = plan_prepared_pack((0, 20 * sk), [torch.int64], 20 * sk)
    swords, _, _ = prepare_packed_batch(sb, [0], splan)
    sw_l, _ = _anchored_pack_word(spr, [0], splan, swords.shape[0])
    _, scnt = _probe_counts(swords, sw_l, spr.count(), sb.count(), splan.tag_bits)
    scsum = torch.cumsum(scnt, 0, dtype=torch.int64).to(torch.int32)
    ranks_errs.append(compare_ranks("sparse_sel_0.001", scsum, 10 * sk, need_global_windows=True))
    del sb, spr, swords, sw_l, scnt, scsum
    hot = torch.zeros(5 * sk, dtype=torch.int32, device=dev)
    hot[5 * sk // 2] = sk
    ranks_errs.append(compare_ranks("one_row_1M_matches", torch.cumsum(hot, 0, dtype=torch.int32), sk + 5))
    ranks_errs.append(compare_ranks("all_miss", torch.zeros(3 * sk, dtype=torch.int32, device=dev), sk))
    dense = torch.cumsum(torch.randint(0, 3, (4 * sk,), generator=gen, device=dev), 0).to(torch.int32)
    total = int(dense[-1])
    ranks_errs.append(compare_ranks("n_out_below_total", dense, total // 2 + 3))
    ranks_errs.append(compare_ranks("n_out_above_total", dense, total + 4097))
    # The merge path's edges: no rows, no or one slot, and rows plus slots
    # at one CTA's merged items and one either side.
    from dj_tpu_torch.ops.expand import RANKS_NV
    ranks_errs.append(compare_ranks("S_0", torch.zeros(0, dtype=torch.int32, device=dev), 4097))
    ranks_errs.append(compare_ranks("n_out_0", dense, 0))
    ranks_errs.append(compare_ranks("n_out_1", dense, 1))
    for extra in (-1, 0, 1):
        ranks_errs.append(compare_ranks(f"S_plus_n_out_is_NV{extra:+d}", dense[:1000],
                                        RANKS_NV - 1000 + extra))
    del hot, dense

    # 9. timings
    S, n_out = timing["S"], timing["n_out"]
    scan_bytes = 8 * S + 4 * 4 * S
    expand_bytes = 4 * 4 * S + 2 * 4 * n_out
    merge_bytes = 16 * merge_timing["S"]
    ranks_bytes = 4 * ranks_timing["S"] + 4 * ranks_timing["n_out"]
    log("timings", join_wall_ms_odf1=walls[1], join_wall_ms_odf4=walls[4],
        peak_bytes_odf1=peaks[1], peak_bytes_odf4=peaks[4], sort_ms=timing["sort_ms"],
        sort_S=S, prepare_wall_ms=prep_walls,
        prepared_query_wall_ms={f"{t}_odf{o}": v for (o, t), v in query_walls.items()},
        merge_S=merge_timing["S"], ranks_S=ranks_timing["S"], ranks_n_out=ranks_timing["n_out"],
        mode_join_wall_ms={f"{m}_odf{o}": v for (m, o), v in mode_walls.items()},
        mode_peak_bytes={f"{m}_odf{o}": v for (m, o), v in mode_peaks.items()},
        mode_kernels_S=mode_timing["S"], mode_kernels_n_out=mode_timing["n_out"],
        card=smi)

    # 10. the hardware probes through their entry points, and a tile pass
    # at the join's scale beside the flat sort of the same words
    from dj_tpu_torch.hw import probe_gather, probe_sort

    sort_probe = run_probe("probe_sort", probe_sort)
    gather_probe = run_probe("probe_gather", probe_gather, ("launches", "cluster_launches"))
    T = probe_sort.TILE

    def words(n, lo=-(2**31), hi=2**31):
        """n u32 words, drawn as int32 in [lo, hi) (negative ones are >= 2^31)."""
        return torch.randint(lo, hi, (n,), dtype=torch.int32, generator=gen,
                             device=dev).view(torch.uint32)

    nt_join = 6104
    xj = words(nt_join * T)
    sort_errs = [compare_tile_sort("join_scale", xj, T)]
    flipped = xj.view(torch.int32) ^ probe_sort.INT32_MIN
    join_scale = {"NT": nt_join, "TILE": T, "S": xj.numel(),
                  "ms": cuda_ms(lambda: probe_sort.tile_sort(xj, T), 3),
                  "library_ms": cuda_ms(lambda: torch.sort(flipped.view(nt_join, T), dim=1), 3),
                  "flat_sort_ms": cuda_ms(lambda: torch.sort(flipped), 3),
                  "bound_ms": 8 * xj.numel() / HBM_BYTES_PER_S * 1e3,
                  "main_path_u64_sort_ms": timing["sort_ms"], "main_path_sort_S": S}
    log("tile_pass_join_scale", **join_scale)
    del xj, flipped

    # 10b. the probe kernels against their plain versions on edge cases
    sort_errs.append(compare_tile_sort("probe_shape", words(probe_sort.NT * T), T))
    sort_errs.append(compare_tile_sort("words_ge_2^31", words(16 * T, hi=0), T))
    sort_errs.append(compare_tile_sort("all_equal_to_padding", words(8 * T, -1, 0), T))
    sorted_tiles = probe_sort.tile_sort_plain(words(8 * T), T)
    sort_errs.append(compare_tile_sort("already_sorted", sorted_tiles, T))
    reverse = sorted_tiles.view(torch.int32).view(8, T).flip(1).reshape(-1).view(torch.uint32)
    sort_errs.append(compare_tile_sort("reverse_sorted", reverse, T))
    dup_set = torch.tensor([0, 1, 2**31 - 1, -(2**31), -1], dtype=torch.int32, device=dev)
    dups = dup_set[torch.randint(0, 5, (16 * T,), generator=gen, device=dev)].view(torch.uint32)
    sort_errs.append(compare_tile_sort("heavy_duplicates", dups, T))
    for tile, nt in ((20_000, 7), (1025, 40), (1024, 40), (1023, 40), (33, 500), (32, 500),
                     (31, 500), (3, 1001), (1, 1000)):
        sort_errs.append(compare_tile_sort(f"tile_{tile}", words(tile * nt), tile))
    del sorted_tiles, reverse, dups

    def indices(n, lo, hi):
        """n int32 indices in [lo, hi), the first ones 0, N - 1, -N, N and
        the int32 extremes."""
        idx = torch.randint(lo, hi, (n,), generator=gen, device=dev).clamp_(-(2**31), 2**31 - 1)
        edge = [0, n - 1, -n, n, -(2**31), 2**31 - 1][:n]
        idx[: len(edge)] = torch.tensor(edge, device=dev)
        return idx.to(torch.int32)

    N = probe_gather.N
    gather_errs = [compare_gather("probe_shape", words(N, 0, 2**30).view(torch.int32),
                                  words(N, 0, N).view(torch.int32))]
    for case, n in (("negative_and_outside", N), ("N_not_multiple_of_cluster", 100_003),
                    ("largest_N", probe_gather.MAX_N), ("N_7", 7), ("N_1", 1)):
        gather_errs.append(compare_gather(case, words(n).view(torch.int32), indices(n, -3 * n, 3 * n)))
    # The L2 gather alone: past the cluster's cap, large, N off the
    # 4-index vectors, and idx 4 bytes off 16-byte alignment (scalar path).
    for case, n in (("past_cluster_cap", probe_gather.MAX_N + 1), ("N_10000003", 10_000_003),
                    ("N_not_multiple_of_4", N + 3)):
        gather_errs.append(compare_gather(case, words(n).view(torch.int32),
                                          indices(n, -3 * n, 3 * n), kernels=("run",)))
    shifted = indices(N + 1, -3 * N, 3 * N)[1:]
    gather_errs.append(compare_gather("idx_not_16_byte_aligned", words(N).view(torch.int32), shifted,
                                      kernels=("run",)))
    del shifted
    too_big = torch.zeros(probe_gather.MAX_N + 1, dtype=torch.int32, device=dev)
    for what, call in (("tile_sort at TILE 32769", lambda: probe_sort.tile_sort(words(32_769), 32_769)),
                       ("run_cluster at N = MAX_N + 1",
                        lambda: probe_gather.run_cluster(too_big, too_big))):
        try:
            call()
        except ValueError as e:
            log("refuses", call=what, error=str(e))
            continue
        raise AssertionError(f"{what} was not refused")
    del too_big
    x_probe = words(probe_sort.NT * T)
    sort_plain_ms = cuda_ms(lambda: probe_sort.tile_sort_plain(x_probe, T), 2)
    gv, gi = words(N, 0, 2**30).view(torch.int32), words(N, 0, N).view(torch.int32)
    gather_plain_ms = probe_gather.graph_ms(lambda: probe_gather.run_plain(gv, gi), 20)
    gather_bound_ms = 12 * gather_probe["n"] / HBM_BYTES_PER_S * 1e3
    del x_probe, gv, gi

    def per_query(name, table=launch_table):
        return {path: {f"odf{odf}": c[name] for odf, c in by_odf.items()}
                for path, by_odf in table.items()
                if any(c[name] for c in by_odf.values())}

    kernels = [
        {
            "name": "join_scans", "route": "cuda", "source": "dj_tpu_torch/csrc/join_scans.cu",
            "replaces": "dj_tpu/ops/pallas_scan.py:237",
            "launches": launch_table["unprepared"][1]["join_scans"],
            "launches_odf4": launch_table["unprepared"][4]["join_scans"],
            "launches_per_query": per_query("join_scans"),
            "max_abs_err": max([e[0] for e in errs] + scan_errs), "ms": timing["scan_ms"],
            "plain_ms": timing["scan_plain_ms"],
            "bound_ms": scan_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "scan_yardstick_ms": timing["cumsum_ms"],
            "scan_yardstick": "torch.cumsum of S int32 (one single-pass scan, not the same function)",
            "lookback_tiles": LOOKBACK,
        },
        {
            "name": "expand_values", "route": "cuda", "source": "dj_tpu_torch/csrc/expand_values.cu",
            "replaces": "dj_tpu/ops/pallas_expand.py:841",
            "launches": launch_table["unprepared"][1]["expand_values"],
            "launches_odf4": launch_table["unprepared"][4]["expand_values"],
            "launches_per_query": per_query("expand_values"),
            "max_abs_err": max([e[1] for e in errs] + probe_errs), "ms": timing["expand_ms"],
            "plain_ms": timing["expand_plain_ms"],
            "bound_ms": expand_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": timing["searchsorted_ms"],
            "library_call": "torch.searchsorted(csum, arange(n_out), right=True)",
            # The probe tier's call under DJT_PROBE_EXPAND=pallas (phase 5d):
            # L probe rows, stag = arange(L), run_start = 0. The (src, t) it
            # needs reads csum alone (csum_ex[src] = csum[src - 1]): 4 bytes
            # a row and 8 an output. The kernel as called also reads cnt,
            # stag and run_start: 16 bytes a row.
            "probe_tier": {"L": probe_timing["L"], "n_out": probe_timing["n_out"],
                           "ms": probe_timing["ms"], "plain_ms": probe_timing["plain_ms"],
                           "bound_ms": (4 * probe_timing["L"] + 8 * probe_timing["n_out"])
                           / HBM_BYTES_PER_S * 1e3,
                           "bound_ms_as_called": (16 * probe_timing["L"]
                                                  + 8 * probe_timing["n_out"])
                           / HBM_BYTES_PER_S * 1e3,
                           "library_ms": probe_timing["library_ms"],
                           "launches": {f"odf{o}": c["expand_values"] for o, c in
                                        launch_table["prepared_probe_pallas"].items()}},
        },
        {
            "name": "merge_sorted_u64", "route": "cuda",
            "source": "dj_tpu_torch/csrc/merge_sorted_u64.cu",
            "replaces": "dj_tpu/ops/pallas_merge.py:200",
            "launches": launch_table["prepared_merge"][1]["merge_sorted_u64"],
            "launches_odf4": launch_table["prepared_merge"][4]["merge_sorted_u64"],
            "launches_per_query": per_query("merge_sorted_u64"),
            "max_abs_err": max(merge_errs), "ms": merge_timing["ms"],
            "plain_ms": merge_timing["plain_ms"],
            "bound_ms": merge_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": merge_timing["library_ms"],
            "library_call": "torch.sort(concat(a, b) ^ 2^63)",
        },
        {
            "name": "expand_ranks", "route": "cuda", "source": "dj_tpu_torch/csrc/expand_ranks.cu",
            "replaces": "dj_tpu/ops/pallas_expand.py:451",
            "launches": launch_table["prepared_probe"][1]["expand_ranks"],
            "launches_odf4": launch_table["prepared_probe"][4]["expand_ranks"],
            "launches_per_query": per_query("expand_ranks"),
            "max_abs_err": max(ranks_errs + [e["expand_ranks"] for e in mode_errs]),
            "ms": ranks_timing["ms"], "plain_ms": ranks_timing["plain_ms"],
            "bound_ms": ranks_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": ranks_timing["library_ms"],
            "library_call": "torch.searchsorted(csum, arange(n_out), right=True, out_int32=True)",
            # The codec's RLE decodes in phase 4g, one a decompress call.
            "launches_codec_4g": codec["expand_ranks_launches"],
            # The same kernel at the unprepared ranks mode's S and n_out.
            "ranks_mode": {"S": mode_timing["S"], "n_out": mode_timing["n_out"],
                           "ms": mode_timing["expand_ranks"]["ms"],
                           "plain_ms": mode_timing["expand_ranks"]["plain_ms"],
                           "bound_ms": 4 * (mode_timing["S"] + mode_timing["n_out"])
                           / HBM_BYTES_PER_S * 1e3,
                           "library_ms": mode_timing["searchsorted_ms"]},
        },
    ]
    # The mode kernels at the main path's S and n_out, with its slots.
    mS, mn, npay = mode_timing["S"], mode_timing["n_out"], mode_timing["n_slots"]
    mode_bytes = {
        "expand_gather": 12 * mS + 12 * mn,
        "expand_join": 12 * mS + 8 * mn,
        "expand_carry": (12 + 8 * npay) * mS + (4 + 8 * npay) * mn,
        "expand_vfull": (20 + 8 * npay) * mS + (8 + 16 * npay) * mn,
    }
    replaces = {"expand_gather": 508, "expand_join": 1380, "expand_carry": 923, "expand_vfull": 1245}
    for name, b in mode_bytes.items():
        mode = next(m for m in MODES if EXPAND_KERNELS[m] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": f"dj_tpu_torch/csrc/{name}.cu",
            "replaces": f"dj_tpu/ops/pallas_expand.py:{replaces[name]}",
            "launches": launch_table[f"unprepared_{mode}"][1][name],
            "launches_odf4": launch_table[f"unprepared_{mode}"][4][name],
            "launches_per_query": per_query(name),
            "max_abs_err": max(e[name] for e in mode_errs), "ms": mode_timing[name]["ms"],
            "plain_ms": mode_timing[name]["plain_ms"],
            "bound_ms": b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": mode_timing["searchsorted_ms"],
            "library_call": "torch.searchsorted(csum, arange(n_out), right=True, out_int32=True), src only",
        })
    kernels.append({
        "name": "tile_sort", "route": "cuda", "source": "dj_tpu_torch/csrc/tile_sort.cu",
        "replaces": "scripts/hw/probe_sort.py:25",
        "launches": sort_probe["launches"], "launches_per_query": {},
        "max_abs_err": max(sort_errs), "ms": sort_probe["ms"], "plain_ms": sort_plain_ms,
        "bound_ms": 8 * sort_probe["n"] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": sort_probe["library_ms"],
        "library_call": "torch.sort(x.view(NT, TILE), dim=1) of the int32 view, top bit flipped",
        "flat_sort_ms": sort_probe["flat_ms"], "NT": sort_probe["nt"], "TILE": sort_probe["tile"],
        "join_scale": join_scale,
    })
    for name, src, prefix, counter in (("run", "take_gather", "", "launches"),
                                       ("run_cluster", "cluster_gather", "cluster_",
                                        "cluster_launches")):
        kernels.append({
            "name": name, "route": "cuda", "source": f"dj_tpu_torch/csrc/{src}.cu",
            "replaces": "scripts/hw/probe_gather.py:26",
            "also_replaces": "scripts/hw/probe_gather.py:59",
            "launches": gather_probe[counter], "launches_per_query": {},
            "max_abs_err": max(gather_errs), "ms": gather_probe[prefix + "ms"],
            "slope_ms": gather_probe[prefix + "slope_ms"], "plain_ms": gather_plain_ms,
            "bound_ms": gather_bound_ms, "bound_by": "bytes",
            "library_ms": gather_probe["library_ms"],
            "library_slope_ms": gather_probe["library_slope_ms"],
            "library_call": "vals[idx] (torch.take)", "N": gather_probe["n"],
            **({} if name == "run" else {"on_path": "none: the study of hw/gather_variants.py"}),
        })
    for k in kernels:
        on_path = bool(k["launches_per_query"])
        k["launches_world4"] = per_query(k["name"], world_launches) if on_path else {}
        k["launches_world4_two_level"] = (per_query(k["name"], two_level_launches)
                                          if on_path else {})
        k["launches_process4_gloo_two_level_by_rank"] = (
            [res["two_level"]["launches"][k["name"]] for res in process4] if on_path else [])
        k["launches_process1_nccl"] = per_query(k["name"], process1_launches) if on_path else {}
        k["launches_process4_gloo_by_rank"] = (
            [res["launches"][k["name"]] for res in process4] if on_path else [])
        k["launches_process4_gloo_broadcast_by_rank"] = (
            [res["broadcast"]["launches"][k["name"]] for res in process4] if on_path else [])
        k["launches_process4_gloo_chain_by_rank"] = (
            [res["chain"]["launches"][k["name"]] for res in process4] if on_path else [])
        if process_n is not None:
            k["launches_process_nccl_by_rank"] = (
                [res["launches"][k["name"]] for res in process_n] if on_path else [])
        k["ptxas"] = ptxas_resources(k["source"])
    log("total", seconds=round(time.perf_counter() - t_start, 1), card=smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
