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
  11. observability on the main path (after 4d, on phase 4's and 4d's
     tables): (a) phase 4's one-rank join and 4d's 4-rank join at odf
     1, three warm walls each with obs off and three inside
     obs.query_ctx with obs on, in turns, their medians and ratio, and
     the synchronizing CUDA calls of one join of each
     (torch.cuda.set_sync_debug_mode("warn")), which must be equal with
     obs off and on; (b) distributed_inner_join_auto in 4d's world at
     join_out_factor 0.1 (one heal) inside query_ctx("q11",
     tenant="smoke"): the timeline's events in the CPU parity test's
     order, dj_heal_total = attempts - 1, dj_join_queries_total
     {path="unprepared"} = attempts, dj_collective_launches_total = the
     all-to-alls rank 0 issued (a quarter of the four ranks'),
     export_trace("q11") a chrome trace whose spans nest, every
     roofline_frac in (0, 1.05]; (c) one 4d join under dj.profile(dir):
     the dj_partition, dj_exchange and dj_join ranges, the join_scans
     and expand_values kernels inside dj_join, each range's device ms
     beside the phase clock's ms, and the cost of one annotate range;
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
  12. the degradation ladder (after 8g, on phase 4's tables): each case
     runs a call unfaulted, with one fault site armed, and unfaulted
     again after faults.reset() and reset_pins(), with obs on: the rows
     equal in all three (and phase 4's for a join), both walls, each
     call's launches and all-to-alls, the fault / degrade / heal /
     reprepare events, the pins and the knobs after the pin. (a)
     DJT_FAULT=module_build@call=1000000 around phase 4's join at odf 1:
     the same launches, no event, no pin; (b) join.join_overflow@call=1
     through distributed_inner_join_auto in 4d's world: one heal, twice
     the launches; (c) pallas_merge@call=1 under DJT_JOIN_MERGE=merge on
     phase 5's prepared side: merge pinned to sort, merge_sorted_u64 not
     launched by the retry; (d) probe_expand@call=1 under the probe tier
     and DJT_PROBE_EXPAND=pallas: pinned to hist, no expand_values in the
     retry; (e) broadcast@call=1 under DJT_PLAN_ADAPT=1 in 4i's world:
     adapt pinned, the retry issues the shuffle plan's all-to-alls; (f)
     bc_prepared_query@call=1 on 5e's broadcast side through the auto
     wrapper: prepared_tier pinned, the side re-prepared on shuffle; (g)
     codec@call=1 on 4f's compressed shuffle_on_auto (every compressed
     column under RLE): the wire pinned, no expand_ranks decode in the
     retry. After every other phase (and in each process of 6b and 6c)
     no tier may be pinned: a pin means a tier failed on the card and
     its baseline served the rows, and the run fails with its reason;
  13. the measurement and control layer (after 12): (a) phase 4's join
     warm at odf 1 and 4 and phase 5's prepared queries under each merge
     tier, each with obs.hbm_model_bytes of the plan it ran, its median
     wall of 3 and model bytes / wall / 3.35 TB/s; prepared_side_bytes of
     phase 5's side beside the allocator's growth across its prepare; (b)
     with obs on, obs.truth.sample_device_hbm() for device 0 equal to
     torch.cuda.memory_allocated(0), its peak at least that, its limit
     the card's total, both gauges set, and measured_admission(80e9)
     under DJT_SERVE_MEASURED_HBM=1 equal to budget - in use - margin;
     (c) DJT_OBS_SKEW=1 in 4d's world at odf 1 and 4: one skew event a
     batch, one partition-count pass a query, each wire-matrix row equal
     to dj_collective_bytes_total (a consistency check of the matrix's
     bookkeeping, which spreads each epoch's bytes over its n links, not
     a measurement), walls with the probe on and off;
     DJT_OBS_SKEW_EVERY=4 probing once in four calls; 4i(ii)'s skewed
     side under DJT_PLAN_ADAPT=1 through the auto wrapper, one pass and
     one event a query, its ratio above the uniform one; (d)
     DJT_AUTOTUNE=1 with a DJT_LEDGER file on 4j's chain at odf 1
     through distributed_join_pipeline_auto: the first call tunes (one
     tune event, every candidate priced by the byte model, two probe
     dispatches, their join_scans and expand_values launches logged), the
     second replays with no probe and an untuned call's launches at the
     winner's odf, a restart (tuner and in-process ledger cleared)
     replays from the file, and DJT_FAULT=autotune_probe@call=1 inside
     degrade_guard(..., tiers=("autotune",)) degrades once and serves
     the defaults; the rows of every call checked as 4j's; each
     candidate's price and probe seconds, the winner and the walls of
     the untuned chain, the tuning call and the replayed call, and stage
     0 alone at each candidate's odf (did the two probed hold the fastest);
  14. the join-index cache and fleet coordination (after 13, on phase 5's
     build side): (a) one rank at odf 1: JoinIndexCache().get_or_prepare
     misses and prepares once (its wall beside phase 5's warm prepare),
     the hit returns the same side with no launch, dispatch or
     collective (its wall), resident_bytes equals prepared_side_bytes
     (beside the allocator's growth across the miss), and a query through
     lease.prepared under each merge tier, rows checked, launches logged;
     (b) DJT_INDEX_HBM_BUDGET at 1.5 entries: a second entry evicts the
     LRU unpinned one (the allocator flat across that insert, which adds
     a side of the evicted one's size) and shed_bytes drops the
     allocator by the shed side's bytes, each within 1% plus the
     allocator's rounding of the side's blocks (1 MiB + 512 bytes a
     block), the requested bytes by the side within 1%; at 2.5
     entries with two pinned, a third raises AdmissionRejected and the
     residency stays; (c) at odf 4, 5c's 1% rows through append_rows (one
     append event; each tier's query equal to a fresh prepare of the
     combined table), then 1000 rows past the anchored pack's key field
     (one reprepare event, its query checked); (d) DJT_INDEX_MANIFEST, clear(),
     a new cache's warm_restart (count, restore events) and
     warmup_join_index, the first live query's wall beside a warm one's;
     (e) 4d's world: a cached side at odf 1, a free hit, each tier's rows
     checked and on their hash's shard; available_broadcast_bytes() the
     budget less the resident bytes, and DJT_BROADCAST_BYTES between 4i's
     replicated side and that plus the entry turns 4i's broadcast plan
     into the shuffle plan (rows checked) while it fits with the cache
     empty; (f) DJT_FLEET_DIR: a miss holds the prepare lease while the
     manifest's insert line (with pid and host) is written and releases
     it after, then DJT_FAULT=fleet.lease_acquire@call=1 degrades once,
     pins fleet and builds locally (rows checked), and reset_pins();
  15. admission and the query scheduler (after 14, on phase 4's and
     phase 5's tables; DJT_SERVE_HBM_BUDGET set to twice the larger
     forecast, since dj_tpu's 16e9 default refuses a full-width query):
     (a) one rank at odf 1 and 4, QueryScheduler with its worker thread:
     each served query's rows equal phase 4's and its launches the direct
     distributed_inner_join_auto's; the forecast beside the card's bytes
     and the allocator's peak, the serve event's queued, run and total
     seconds, the served wall beside the direct one, and
     dj_forecast_error_ratio holding every served result; (b) four
     queries, each on a quarter of the probe table, against phase 5's
     side under each merge tier: one coalesce event of 4, each member's
     rows equal to its singleton's, each tier's kernels launched once a
     member; DJT_FAULT=prepared.join_overflow@call=1 demotes member 0 to
     the singleton heal, rows checked; (c) a budget one byte under the
     forecast rejects at submit with no launch, dispatch or collective,
     and DJT_SERVE_MEASURED_HBM=1 rejects against the allocator's
     headroom with source measured_hbm and its bytes in use; (d) a
     deadline expired in the queue sheds "queued" with no launch, and a
     healing query (join_out_factor 0.01) sheds "healing" after its
     first attempt; (e) queries priced past the budget walk the pressure
     ladder: level 1 pins wire, level 2 pins merge (a merge-tier query
     then launches no merge_sorted_u64, rows checked), level 3 halves an
     odf-4 query (join_scans and expand_values twice), then reset_pins
     and reset_pressure; (f) a scheduler with a JoinIndexCache: the
     second query is an index hit with no prepare, a pinned side's bytes
     count at the door, and an unpinned one is shed to admit; (g) 4d's
     world: a served query at odf 1 on the worker, rows checked and on
     their shard, then fleet.drain.begin(): a new submit raises
     Draining and the queued query finishes; (h) 40 seeded queries (the
     four members against a quarter of the build table, unprepared at
     odf 1 and 4 and through its prepared side) under DJT_FAULT at four
     sites, over-budget and expired ones among them, on the worker in
     groups of at most 4: every ticket ends once with a result (rows
     counted against the member's direct join) or a typed DJError other
     than BackendError, every query span closed, no pin left;
  16. the observatory (after 15, on phase 4's and 5's tables and 4d's
     world): (a) phase 4's join served 3 times warm (worker=False) with
     the endpoint off, then with DJT_OBS_HTTP=0 started through
     init_distributed's hook (history sampler at DJT_OBS_HISTORY_S=0.25)
     and a thread scraping every route in a loop: median walls and their
     ratio, each route's scrapes and median ms, launches of join_scans
     and expand_values and the synchronizing calls (sync debug mode)
     equal off and on, every route 200 but /tracez without q and
     /profilez without its directory (400), /metrics Prometheus text with
     dj_serve_latency_seconds buckets, /healthz's device_hbm equal to
     memory_allocated() read around it; (b) with DJT_OBS_PROFILE_DIR set,
     /profilez?secs=2 on a live server while its worker thread serves
     phase 5's side on the sort, merge and probe tiers: a second request
     answers 409, the written Chrome trace names join_scans_kernel,
     expand_values_kernel, merge_splits_kernel, merge_kernel,
     ranks_partition, ranks_merge and CUB's radix sort among its CUDA
     kernels, a query's wall inside the capture beside one outside; (c)
     served queries and queued deadline sheds on sample_now(now=) ticks:
     the fast deadline_miss window fires before the slow one, one
     slo_alert event a transition, /trendz holds the snapshots with the
     allocator's sample; (d) 4d's join with DJT_OBS_SKEW=1 and
     DJT_FLEET_DIR: the fleet snapshots feed the anomaly window through
     skew's hook, /fleetz shows the window, thresholds, scores and the
     coordination block, and no anomaly fires; (e) `python -m
     dj_tpu_torch.scripts.chaos_soak --hard-death` at this run's rows on
     the card: the child dies by SIGTERM with 4 queries in flight and
     the audit of its bundle passes; the phase leaves no device bytes and
     no dj-obs thread behind;
  17. the soak on the card (after 16): (a) the soak's main walk,
     chaos_soak.main_walk (the default arm of `python -m
     dj_tpu_torch.scripts.chaos_soak`), at 1M rows (--rows, if smaller)
     in a 4-rank world on this card: every spec of FAULT_WALK under the
     scheduler with the planner, the skew probe, the probe tier, the
     measured gate (budget: the card's bytes), the prepared tiers and the
     tuner armed; every ticket ends once, rows checked, one pin of each
     faulted tier's own, the collective audits pass (the walk's stand-in
     for dj_tpu's HLO audit) and /healthz's allocator sample equals
     memory_allocated(); join_scans, expand_values, expand_ranks and
     merge_sorted_u64 each launched; (b) the fleet drill (--fleet) at
     the same rows in 8-rank worlds: three peers in processes of their
     own, each with its own CUDA context on this card, one defer, one
     reclaim, a replay with no prepare heal; (c) the native host runtime built from
     native/dj_native.cpp into dj_tpu_torch/_build/ (no fallback):
     native.murmur3_32 of phase 4's build keys on the host equal to the
     port's hash of them on the card at seeds 0 and 12345678, and a 10M x
     10M pair from native.generate_build_probe (selectivity 0.3, unique
     build keys) joined on one rank: the count native.expected_match_count
     exactly, every flag False. The phase leaves no device bytes, no pin,
     no child process and no dj-obs thread; it logs its seconds, peak
     and each part's launches. The parquet reader (data/io.py) is not
     driven: the card's machine has no pyarrow;
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
layers' 4j, 4k and 5f, phase 13's tuned chain and probes and phase
14's cached sides, phase 15's served queries and phase 16's served, profiled
and 4-rank queries among its paths), phase 17's (the walk, the drill's
parent and the native-generated join), its two-level form and the
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
import collections
import concurrent.futures
import contextlib
import gc
import io
import json
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
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
def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from dj_tpu_torch.ops import reset_kernel_launches

    reset_kernel_launches()


def read_launches() -> dict:
    from dj_tpu_torch.ops import kernel_launches

    return kernel_launches()


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
    from dj_tpu_torch.utils.timing import is_span_key

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
    busy = sum(v for k, v in total.items() if not is_span_key(k))
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


# --- observability on the main path (phase 11) ---------------------------


@contextlib.contextmanager
def obs_on():
    """The port's obs enabled, with a clean registry, ring and timelines,
    for the block; the former state after."""
    from dj_tpu_torch import obs

    was = obs.enabled()
    obs.reset(reenable=True)
    obs.drain()
    try:
        yield obs
    finally:
        obs.reset(reenable=was)
        obs.drain()


def sync_calls(fn) -> dict:
    """The synchronizing CUDA calls one call of fn makes, as torch's
    sync debug mode warns of them: {"file:line" of the Python call that
    synchronized: count}."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        del res
    torch.cuda.synchronize()
    where: dict = {}
    for w in caught:
        if "synchronizing" in str(w.message):
            k = f"{pathlib.Path(w.filename).name}:{w.lineno}"
            where[k] = where.get(k, 0) + 1
    return where


def obs_overhead(what: str, join, reps: int = 3) -> dict:
    """Phase 11a for one join: warm walls with obs off and on, in turns
    (off, on, on, off, off, on), and the synchronizing calls of one join
    each way, which must be equal."""
    walls: dict = {"off": [], "on": []}
    for k, mode in enumerate(("off", "on", "on", "off", "off", "on")[: 2 * reps]):
        with obs_on() if mode == "on" else contextlib.nullcontext() as obs:
            ctx = obs.query_ctx(f"q11a-{what}-{k}", "smoke") if obs else contextlib.nullcontext()
            with ctx:
                t0 = time.perf_counter()
                res = join()
                torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t0) * 1e3)
            del res
            if obs:
                obs.events()  # resolve the join's device phases
    # The process's first call under the sync debug mode makes one
    # synchronize of its own (in torch/cuda/__init__.py, on the H100):
    # a discarded call first.
    sync_calls(join)
    syncs_off = sync_calls(join)
    with obs_on() as obs:
        with obs.query_ctx(f"q11a-{what}-sync", "smoke"):
            syncs_on = sync_calls(join)
        phases = [e["phase"] for e in obs.events("phase")]
    if syncs_on != syncs_off:
        raise AssertionError(f"11a {what}: synchronizing calls by caller with obs off "
                             f"{syncs_off}, with obs on {syncs_on}")
    # Joins back to back with obs on and no reader between them: each
    # phase's start resolves the completed ones, so the pending device
    # phases stay bounded, and the registry's reader gives every dispatch.
    n_loop = 5
    with obs_on() as obs:
        pending = []
        for _ in range(n_loop):
            res = join()
            del res
            pending.append(obs.roofline.pending_count())
        hists = obs.metrics_summary()["histograms"]
        left = obs.roofline.pending_count()
    dispatches = hists.get('dj_phase_seconds{phase="dispatch"}', {}).get("count")
    if max(pending) > 2 or left or dispatches != n_loop:
        raise AssertionError(f"11a {what}: pending device phases after each of {n_loop} joins "
                             f"{pending}, {left} after metrics_summary, which shows "
                             f"{dispatches} dispatches")
    syncs_off = sum(syncs_off.values())
    syncs_on = sum(syncs_on.values())
    off, on = statistics.median(walls["off"]), statistics.median(walls["on"])
    return {"wall_ms_obs_off": off, "wall_ms_obs_on": on, "on_over_off": on / off,
            "pending_after_each_join": pending,
            "wall_ms_runs_obs_off": walls["off"], "wall_ms_runs_obs_on": walls["on"],
            "sync_calls_obs_off": syncs_off, "sync_calls_obs_on": syncs_on,
            "phases_obs_on": phases}


def range_kernels(prof, name: str) -> tuple[dict, float, int]:
    """({kernel name: device ms}, the profiler's own device span ms of
    the ranges, ranges) of the device work inside the profiler ranges
    called ``name``. A range's window on the device runs from the first
    to the last kernel that the ops inside it launched (their linked
    correlation ids); every kernel the device ran in that window is the
    range's. All ranks issue on one stream, one rank at a time, so the
    window also holds the kernels the package launches through ctypes,
    which the profiler links to no op. The profiler also projects each
    range onto the device (a device event of the range's name): that is
    the span, not a kernel."""
    raw = prof.profiler.kineto_results.events()

    def end(e):
        return e.end_ns() if hasattr(e, "end_ns") else e.start_ns() + e.duration_ns()

    cpu = [e for e in raw if e.device_type() == torch.autograd.DeviceType.CPU]
    dev = [e for e in raw if e.device_type() == torch.autograd.DeviceType.CUDA]
    linked: dict = {}
    for k in dev:
        linked.setdefault(k.linked_correlation_id(), []).append(k)
    ranges = [e for e in cpu if e.name() == name]
    labels = {e.name() for e in cpu if getattr(e, "is_user_annotation", lambda: False)()}
    labels.add(name)
    span = sum((end(k) - k.start_ns()) / 1e6 for k in dev if k.name() == name)
    out: dict = {}
    for r in ranges:
        inside = {e.correlation_id() for e in cpu if e.start_thread_id() == r.start_thread_id()
                  and r.start_ns() <= e.start_ns() and end(e) <= end(r)}
        mine = [k for i in inside for k in linked.get(i, ())]
        if not mine:
            continue
        lo, hi = min(k.start_ns() for k in mine), max(end(k) for k in mine)
        for k in dev:
            if lo <= k.start_ns() and end(k) <= hi and k.name() not in labels:
                out[k.name()] = out.get(k.name(), 0.0) + (end(k) - k.start_ns()) / 1e6
    return out, span, len(ranges)


def run_observability(dj, dev, topo1, left1, lcnt1, right1, rcnt1, build, probe, expected: int,
                      ref, rows: int, smi: str) -> dict:
    """Phase 11 (module docstring): obs on the main path at full width.
    Returns {path: {odf: launches}} of the healed 4-rank join."""
    from dj_tpu_torch.parallel.communicator import InProcessTransport
    from dj_tpu_torch.resilience import ledger

    topo = dj.make_topology([dev] * WORLD)
    left, lcnt = dj.shard_table(topo, probe)
    right, rcnt = dj.shard_table(topo, build)
    cfg = dj.JoinConfig()

    def join1():
        return dj.distributed_inner_join(topo1, left1, lcnt1, right1, rcnt1, [0], [0], cfg)

    def join4():
        return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)

    # (a) the cost of obs on the main path, and no new synchronizing call
    overhead = {"one_rank": obs_overhead("one_rank", join1),
                "world4": obs_overhead("world4", join4)}
    for what, o in overhead.items():
        log("obs_overhead", smoke_phase="11a", path=what, odf=1, rows=rows,
            obs_on="obs.enable() (DJT_OBS=1) inside obs.query_ctx", **o, card=smi)
    torch.cuda.empty_cache()

    # (b) the events and counters of a healed join in 4d's world
    ledger.reset()
    a2a = {"all": 0, "rank0": 0}
    orig = InProcessTransport.all_to_all_start

    def counted(transport, *a, **k):
        a2a["all"] += 1
        a2a["rank0"] += transport.rank() == 0
        return orig(transport, *a, **k)

    tight = dj.JoinConfig(join_out_factor=0.1)
    with obs_on() as obs:
        InProcessTransport.all_to_all_start = counted
        try:
            reset_launches()
            with Attempts() as att, obs.query_ctx("q11", tenant="smoke"):
                with obs.span("query"), obs.span("run"):
                    t0 = time.perf_counter()
                    out, counts, info, used = dj.distributed_inner_join_auto(
                        topo, left, lcnt, right, rcnt, [0], [0], tight)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
            launches = read_launches()
        finally:
            InProcessTransport.all_to_all_start = orig
        flags_false("11b", info)
        flat = dj.unshard_table(out, counts)
        flat_counts = torch.tensor([flat.capacity])
        check_rows(flat, flat_counts, build, probe, expected)
        check_same_rows(sorted_rows(flat, flat_counts), ref, "11b")
        del out, counts, info, flat
        tr = obs.query_trace("q11")
        events = [e for e in tr["events"] if e["type"] != "span"]
        kinds = [e["phase"] if e["type"] == "phase" else e["type"] for e in events]
        attempts = att.n
        want = (["probe", "collectives", "dispatch", "sync", "heal"] * (attempts - 1)
                + ["probe", "collectives", "dispatch", "sync"])
        if attempts != 2 or kinds != want:
            raise AssertionError(f"11b: {attempts} attempts, events {kinds}, not {want}")
        heals = obs.counter_value("dj_heal_total", flag="join_overflow")
        queries = obs.counter_value("dj_join_queries_total", path="unprepared")
        coll = obs.counter_value("dj_collective_launches_total")
        if heals != attempts - 1 or queries != attempts:
            raise AssertionError(f"11b: dj_heal_total {heals}, dj_join_queries_total {queries} "
                                 f"for {attempts} attempts")
        if coll != a2a["rank0"] or WORLD * coll != a2a["all"]:
            raise AssertionError(f"11b: dj_collective_launches_total {coll}; the ranks issued "
                                 f"{a2a['all']} all-to-alls, rank 0 {a2a['rank0']}")
        export = json.loads(json.dumps(obs.export_trace("q11")))
        spans = {e["name"]: e for e in export["traceEvents"]
                 if e["ph"] == "X" and e.get("cat") == "span"}
        q, r = spans["query"], spans["run"]
        if not (q["ts"] <= r["ts"] and r["ts"] + r["dur"] <= q["ts"] + q["dur"] + 1.0):
            raise AssertionError(f"11b: the exported spans do not nest: {q}, {r}")
        fracs = {f"{e['stage']}:{e['phase']}#{i}": e["roofline_frac"]
                 for i, e in enumerate(events) if e["type"] == "phase"
                 and e["roofline_frac"] is not None}
        if not fracs or not all(0 < f <= 1.05 for f in fracs.values()):
            raise AssertionError(f"11b: roofline_frac outside (0, 1.05]: {fracs}")
        phase_s = {f"{e['phase']}#{i}": e["seconds"] for i, e in enumerate(events)
                   if e["type"] == "phase"}
        bytes_by_width = obs.counter_series("dj_collective_bytes_total")
        log("obs_healed_join", smoke_phase="11b", ranks=WORLD, odf=1, attempts=attempts,
            factors_used={f: getattr(used, f) for f in FACTOR_FIELDS}, events=kinds,
            dj_heal_total=heals, dj_join_queries_total=queries,
            dj_collective_launches_total=coll, all_to_alls_all_ranks=a2a["all"],
            dj_collective_bytes_total={dict(k)["width"]: v for k, v in bytes_by_width.items()},
            roofline_frac=fracs, phase_seconds=phase_s, trace_events=len(export["traceEvents"]),
            wall_ms=wall, launches=launches, total=expected, rows_checked=expected, card=smi)
    ledger.reset()
    torch.cuda.empty_cache()

    # (c) the profiler's ranges and the kernels inside them
    with tempfile.TemporaryDirectory() as tmp:
        with dj.profile(tmp) as prof:
            res = join4()
            torch.cuda.synchronize()
        del res
        trace_bytes = os.path.getsize(os.path.join(tmp, "trace.json"))
    ranges = {name: range_kernels(prof, name)
              for name in ("dj_partition", "dj_exchange", "dj_join", "dj_concat")}
    missing = [name for name, (_, _, n) in ranges.items() if not n]
    if missing:
        raise AssertionError(f"11c: the profiler trace has no {missing} range")
    inside_join = ranges["dj_join"][0]
    for kernel in ("join_scans", "expand_values"):
        if not any(kernel in k for k in inside_join):
            raise AssertionError(f"11c: no {kernel} kernel inside dj_join: {sorted(inside_join)}")
    clock = world_phases(join4)["phase_ms"]
    by_range = {name: {"ranges": n, "kernel_ms": sum(kernels.values()), "device_span_ms": span,
                       "phase_clock_ms": clock.get(name)}
                for name, (kernels, span, n) in ranges.items()}
    from dj_tpu_torch.utils.timing import annotate

    def annotate_us(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with annotate("t11", dev):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    # One range's host cost with no profiler (an NVTX push and pop) and
    # under a profiler (record_function as well).
    us_off = annotate_us(20_000)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        us_on = annotate_us(2_000)
    log("obs_profile", smoke_phase="11c", ranks=WORLD, odf=1, by_range=by_range,
        kernels_inside_dj_join={k[:60]: ms for k, ms in sorted(inside_join.items(),
                                                               key=lambda kv: -kv[1])[:12]},
        trace_bytes=trace_bytes, annotate_us_per_range_no_profiler=us_off,
        annotate_us_per_range_under_profiler=us_on, card=smi)
    del left, lcnt, right, rcnt
    torch.cuda.empty_cache()
    return {"world4_auto_obs": {1: launches}}


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
    marked inside it, summed (the spans inside them are already in them)."""
    from dj_tpu_torch.utils.timing import is_span_key

    return sum(v for k, v in phases.items()
               if k.startswith("dj_pre_shuffle") and not is_span_key(k))


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


def env_set(**kv):
    """The DJT_* variables ``kv`` set inside the block, restored after."""
    from dj_tpu_torch import knobs

    return knobs.scoped(kv)


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
    gen = torch.Generator(device=dev).manual_seed(14)
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
    gen = torch.Generator(device=dev).manual_seed(14)
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
        with StringPasses() as timer:
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
    topo = dj.make_topology([dev] * WORLD)
    left, lcnt, right, rcnt, b2, b2c = chain_tables(dj, topo, build, probe)
    check_colocated("4j build copy", b2, b2c, 1)
    stages = chain_stages(dj, right, rcnt, b2, b2c)
    torch.cuda.synchronize()
    launch_table: dict = {}
    for odf in (1, 4):
        cfg = dj.JoinConfig(over_decom_factor=odf)
        with obs_on() as obs:
            plan = dj.plan_pipeline(topo, left, lcnt, stages, cfg)
            probes = obs.counter_value("dj_range_probe_total", result="probe")
            dj.plan_pipeline(topo, left, lcnt, stages, cfg)
            replan_probes = obs.counter_value("dj_range_probe_total", result="probe") - probes
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
        with StageCalls() as calls, StringPasses() as timer:
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
    with env_set(DJT_SHAPE_BUCKET="1"), obs_on() as obs:
        def totals():
            return {r: obs.counter_value("dj_shape_bucket_total", result=r)
                    for r in ("pad", "memo_hit")}

        pads = totals()
        reset_launches()
        with Epochs() as ep:
            per_query, used = dj.distributed_inner_join_coalesced_unprepared(topo, *args)
            torch.cuda.synchronize()
        launches = read_launches()
        padded = totals()["pad"] - pads["pad"]
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

    with env_set(DJT_SHAPE_BUCKET="1"):
        # Timed with obs off, as the singletons are.
        wall, runs, peak = warm_walls(coalesced)
        with obs_on() as obs:
            res = coalesced()
            torch.cuda.synchronize()
            del res
            repads = obs.counter_value("dj_shape_bucket_total", result="pad")
            memo_hits = obs.counter_value("dj_shape_bucket_total", result="memo_hit")
        if repads:
            raise AssertionError(f"4k: a warm call padded {repads} tables again")
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
        members_equal_singletons=True, pads=padded, memo_hits_one_warm_call=memo_hits,
        wall_obs="off on both sides", epoch_starts=ep.n, launches=launches, wall_ms=wall,
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


# --- the degradation ladder on the card (phase 12) ----------------------------

LADDER_EVENTS = ("fault", "degrade", "heal", "reprepare")


def check_no_pins(phase: str) -> None:
    """After every phase but 12: no tier of the degradation ladder pinned
    and dj_degrade_total at 0. A pin means a tier failed on the card and
    the ladder served its baseline instead (the rows would still be
    right), so the run fails, printing each pin's reason. Pins last until
    reset_pins(), which phase 12 alone calls, so a pin in any earlier
    phase shows here; the counter moves only while obs is on."""
    from dj_tpu_torch import obs, resilience

    pins = resilience.pinned_tiers()
    moved = obs.counter_value("dj_degrade_total")
    if pins or moved:
        for tier, reason in pins.items():
            print(f"[degrade] phase {phase}: tier {tier} pinned: {reason}", flush=True)
        for e in obs.events("degrade"):
            print(f"[degrade] phase {phase}: {json.dumps(e, default=str)}", flush=True)
        raise AssertionError(f"phase {phase}: the degradation ladder pinned {sorted(pins)} "
                             f"(dj_degrade_total {moved}): a tier failed on the card")


def ladder_case(what: str, call, rows_of, *, spec=None, fault_env=None, env=None, kernel=None,
                collectives=False) -> dict:
    """One case of phase 12: ``call()`` unfaulted, then with the fault
    ``spec`` armed (``faults.configure``) or the variables ``fault_env``
    set (DJT_FAULT), then unfaulted again after ``faults.reset()`` and
    ``reset_pins()``; all under the knobs ``env`` and with obs on. Each
    call's wall (synchronized), kernel launches, in-process collectives
    and ladder events; ``rows_of(result)`` of each must be equal. With
    ``kernel`` the tier's kernel must launch in the first and last calls
    and not in the faulted one (whose failed attempt launches nothing:
    every fault site is consulted before the ranks start); with
    ``collectives`` the tier issues no all-to-all and its baseline does.
    Returns the case's fields; the caller checks the pins and events."""
    from dj_tpu_torch.resilience import errors, faults

    out: dict = {}
    faults.reset()
    with env_set(**(env or {})), obs_on() as obs:
        for run in ("clean", "faulted", "after_reset"):
            armed = run == "faulted"
            if armed and spec is not None:
                faults.configure(spec)
            reset_launches()
            with env_set(**(fault_env if armed and fault_env else {})), Collectives() as coll:
                t0 = time.perf_counter()
                res = call()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            rows = rows_of(res)
            del res
            out[run] = {"wall_ms": wall, "launches": read_launches(), "collectives": coll.counts,
                        "events": [{k: v for k, v in e.items() if k not in ("seq", "ts")}
                                   for e in obs.drain() if e["type"] in LADDER_EVENTS]}
            if run == "clean":
                want = rows
            elif not all(torch.equal(g, w) for g, w in zip(rows, want)):
                raise AssertionError(f"12 {what}: the {run} call's rows differ from the clean "
                                     f"call's")
            if armed:
                out["pins"] = errors.pinned_tiers()
                out["knobs_after_pin"] = {k: os.environ.get(k) for k in
                                          ("DJT_JOIN_MERGE", "DJT_PROBE_EXPAND", "DJT_PLAN_ADAPT",
                                           "DJT_PREPARED_TIER")}
                out["degrade_total"] = obs.counter_value("dj_degrade_total")
                faults.reset()
                errors.reset_pins()
        del want
    if out["after_reset"]["events"] or out["clean"]["events"]:
        raise AssertionError(f"12 {what}: events outside the faulted call: {out}")
    if kernel is not None:
        n = [out[run]["launches"][kernel] for run in ("clean", "faulted", "after_reset")]
        if not (n[0] >= 1 and n[1] == 0 and n[2] >= 1):
            raise AssertionError(f"12 {what}: {kernel} launched {n} times (clean, faulted, "
                                 f"after reset_pins): the retry must not run it")
    if collectives:
        n = [out[run]["collectives"]["all_to_all_start"]
             for run in ("clean", "faulted", "after_reset")]
        if not (n[0] == 0 and n[1] >= 1 and n[2] == 0):
            raise AssertionError(f"12 {what}: all-to-alls {n} (clean, faulted, after "
                                 f"reset_pins): the tier issues none, its baseline does")
    return out


def check_pin(what: str, case: dict, tier: Optional[str], site: str, knob=None) -> None:
    """The faulted call pinned ``tier`` alone (None: nothing), with one
    fault event of ``site`` first, one degrade event of ``tier`` and
    dj_degrade_total 1, and wrote the baseline into ``knob`` (name,
    value)."""
    evs = case["faulted"]["events"]
    if not evs or evs[0] != {"type": "fault", "site": site, "call": 1}:
        raise AssertionError(f"12 {what}: first event {evs[:1]}, expected the fault of {site}")
    degrades = [e for e in evs if e["type"] == "degrade"]
    if tier is None:
        if case["pins"] or degrades or case["degrade_total"]:
            raise AssertionError(f"12 {what}: pinned {case['pins']}, expected no pin")
        return
    if list(case["pins"]) != [tier] or [e["tier"] for e in degrades] != [tier] \
            or case["degrade_total"] != 1:
        raise AssertionError(f"12 {what}: pins {case['pins']}, degrades {degrades}, "
                             f"dj_degrade_total {case['degrade_total']}; expected {tier}")
    if knob is not None and case["knobs_after_pin"][knob[0]] != knob[1]:
        raise AssertionError(f"12 {what}: {knob[0]}={case['knobs_after_pin'][knob[0]]} after "
                             f"the pin, expected {knob[1]}")


def run_ladder(dj, dev, topo1, left1, lcnt1, right1, rcnt1, ref, rows: int, seed: int,
               smi: str) -> dict:
    """Phase 12: the degradation ladder and the fault sites on the card,
    each case a ``ladder_case`` (clean, faulted, after reset_pins) at full
    width: (a) DJT_FAULT=module_build@call=1000000 around phase 4's join
    at odf 1 changes no launch and records no event; (b)
    join.join_overflow@call=1 through distributed_inner_join_auto in 4d's
    world costs one heal and one more attempt; (c) pallas_merge@call=1
    under DJT_JOIN_MERGE=merge and (d) probe_expand@call=1 under
    DJT_JOIN_MERGE=probe and DJT_PROBE_EXPAND=pallas on phase 5's
    prepared side pin sort / hist, and the retry launches no
    merge_sorted_u64 / expand_values; (e) broadcast@call=1 under
    DJT_PLAN_ADAPT=1 on 4i's tables pins DJT_PLAN_ADAPT=0 and the retry
    issues the shuffle plan's all-to-alls; (f) bc_prepared_query@call=1
    on 5e's broadcast side pins DJT_PREPARED_TIER=shuffle and the auto
    wrapper re-prepares on shuffle; (g) codec@call=1 on 4f's compressed
    shuffle_on_auto (every compressed column under RLE, so its decode
    launches expand_ranks) pins the wire and the retry decodes nothing.
    Returns {case: fields}."""
    from dj_tpu_torch.ops.hashing import DEFAULT_HASH_SEED
    from dj_tpu_torch.resilience import ledger

    t_phase = time.perf_counter()
    cases: dict = {}

    def join_rows(res):
        """A join's rows (one rank's, or a world's unsharded), its flags
        False and its rows phase 4's."""
        flags_false("12", res[2])
        out, counts = res[0], res[1]
        if counts.shape[0] > 1:
            out = dj.unshard_table(out, counts)
            counts = torch.tensor([out.capacity])
        rows_ = sorted_rows(out, counts)
        check_same_rows(rows_, ref, "12")
        return rows_

    # (a) an armed site that never fires.
    cfg1 = dj.JoinConfig(over_decom_factor=1)
    a = ladder_case(
        "(a)", lambda: dj.distributed_inner_join(topo1, left1, lcnt1, right1, rcnt1, [0], [0],
                                                 cfg1),
        join_rows, fault_env={"DJT_FAULT": "module_build@call=1000000"})
    if a["faulted"]["events"] or a["pins"] or a["clean"]["launches"] != a["faulted"]["launches"]:
        raise AssertionError(f"12 (a): the armed run differs: {a}")
    cases["a_armed_never_fires"] = a

    topo4 = dj.make_topology([dev] * WORLD)
    left4, lcnt4 = dj.shard_table(topo4, dj.unshard_table(left1, lcnt1))
    right4, rcnt4 = dj.shard_table(topo4, dj.unshard_table(right1, rcnt1))

    # (b) a forced overflow through the auto wrapper: one heal.
    ledger.reset()
    b = ladder_case(
        "(b)", lambda: dj.distributed_inner_join_auto(topo4, left4, lcnt4, right4, rcnt4, [0],
                                                      [0], dj.JoinConfig()),
        join_rows, spec="join.join_overflow@call=1")
    ledger.reset()
    check_pin("(b)", b, None, "join.join_overflow")
    if [e["type"] for e in b["faulted"]["events"]] != ["fault", "heal"] or \
            b["faulted"]["launches"]["join_scans"] != 2 * b["clean"]["launches"]["join_scans"]:
        raise AssertionError(f"12 (b): expected one heal and twice the launches: {b}")
    cases["b_join_overflow_auto"] = b

    # (c), (d) the merge tier and the probe tier's expansion.
    cfgp = dj.JoinConfig(over_decom_factor=1, key_range=(0, 2 * rows))
    prep = dj.prepare_join_side(topo1, right1, rcnt1, [0], cfgp, left_capacity=rows)

    def query():
        return dj.distributed_inner_join(topo1, left1, lcnt1, prep, None, [0], None, cfgp)

    c = ladder_case("(c)", query, join_rows, spec="pallas_merge@call=1",
                    env={"DJT_JOIN_MERGE": "merge"}, kernel="merge_sorted_u64")
    check_pin("(c)", c, "merge", "pallas_merge", ("DJT_JOIN_MERGE", "sort"))
    cases["c_pallas_merge"] = c
    d = ladder_case("(d)", query, join_rows, spec="probe_expand@call=1",
                    env={"DJT_JOIN_MERGE": "probe", "DJT_PROBE_EXPAND": "pallas"},
                    kernel="expand_values")
    check_pin("(d)", d, "expand", "probe_expand", ("DJT_PROBE_EXPAND", "hist"))
    if d["faulted"]["launches"]["expand_ranks"] < 1:
        raise AssertionError(f"12 (d): the hist retry launched no expand_ranks: {d}")
    cases["d_probe_expand"] = d
    del prep

    # (e) the broadcast plan in 4i's world.
    ledger.reset()
    e = ladder_case(
        "(e)", lambda: dj.distributed_inner_join(topo4, left4, lcnt4, right4, rcnt4, [0], [0]),
        join_rows, spec="broadcast@call=1", env={"DJT_PLAN_ADAPT": "1"}, collectives=True)
    ledger.reset()
    check_pin("(e)", e, "adapt", "broadcast", ("DJT_PLAN_ADAPT", "0"))
    cases["e_broadcast"] = e

    # (f) 5e's broadcast-prepared side.
    cfgw = dj.JoinConfig(key_range=(0, 2 * rows))
    with env_set(DJT_PREPARED_TIER="broadcast"):
        bprep = dj.prepare_join_side(topo4, right4, rcnt4, [0], cfgw, left_capacity=rows)
    if bprep.tier != "broadcast":
        raise AssertionError(f"12 (f): the side prepared on {bprep.tier}")
    sides = []

    def bc_query():
        res = dj.distributed_inner_join_auto(topo4, left4, lcnt4, bprep, None, [0], None, cfgw)
        sides.append(res[4].tier)
        return res

    f = ladder_case("(f)", bc_query, join_rows, spec="bc_prepared_query@call=1",
                    env={"DJT_PREPARED_TIER": "broadcast"}, collectives=True)
    check_pin("(f)", f, "prepared_tier", "bc_prepared_query", ("DJT_PREPARED_TIER", "shuffle"))
    if sides != ["broadcast", "shuffle", "broadcast"] or \
            [ev["type"] for ev in f["faulted"]["events"]] != ["fault", "degrade", "reprepare"]:
        raise AssertionError(f"12 (f): sides served {sides}, events {f['faulted']['events']}")
    cases["f_bc_prepared_query"] = f
    del bprep, left4, lcnt4, right4, rcnt4
    ledger.reset()
    torch.cuda.empty_cache()

    # (g) 4f's compressed shuffle, every compressed column under RLE.
    import dataclasses

    table = clickstream_table(dj, dev, rows, seed)
    t4, c4 = dj.shard_table(topo4, table)
    opts = tuple(
        dataclasses.replace(o, cascaded=dataclasses.replace(o.cascaded, num_rles=1))
        if o.method == "cascaded" else o
        for o in dj.broadcast_compression_options(dj.generate_auto_select_compression_options(t4)))

    def shuffled_rows(res):
        counts = check_shuffled("12 (g)", res, table,
                                lambda k, r: key_hash(k, DEFAULT_HASH_SEED) % WORLD == r)
        return (torch.tensor(counts),)

    g = ladder_case("(g)", lambda: dj.shuffle_on_auto(topo4, t4, c4, [0], compression=opts),
                    shuffled_rows, spec="codec@call=1", kernel="expand_ranks")
    ledger.reset()
    check_pin("(g)", g, "wire", "codec")
    cases["g_codec"] = g
    del table, t4, c4
    for name, case in cases.items():
        log("ladder", smoke_phase="12", case=name, rows=rows,
            wall_ms={run: case[run]["wall_ms"] for run in ("clean", "faulted", "after_reset")},
            launches={run: case[run]["launches"] for run in ("clean", "faulted", "after_reset")},
            all_to_alls={run: case[run]["collectives"]["all_to_all_start"]
                         for run in ("clean", "faulted", "after_reset")},
            faulted_events=case["faulted"]["events"], pins=case["pins"],
            knobs_after_pin=case["knobs_after_pin"], card=smi)
    log("ladder_phase", smoke_phase="12", seconds=time.perf_counter() - t_phase, card=smi)
    return cases


# --- the measurement and control layer (phase 13) ---------------------------

PHASE13_ODFS = (1, 4)


class CountPasses:
    """Calls of ``dist_join._partition_probe_counts`` (the partition-count
    pass of the skew probe and of the plan decision) while active."""

    def __enter__(self):
        from dj_tpu_torch.parallel import dist_join

        self.mod, self.orig, self.n = dist_join, dist_join._partition_probe_counts, 0

        def counted(*a, **k):
            self.n += 1
            return self.orig(*a, **k)

        dist_join._partition_probe_counts = counted
        return self

    def __exit__(self, *exc):
        self.mod._partition_probe_counts = self.orig


class Probes:
    """The autotuner's probe dispatches while active: per probe the
    candidate's odf, host seconds and the kernel launches it made."""

    def __enter__(self):
        from dj_tpu_torch.parallel import dist_join

        self.mod, self.orig, self.runs = dist_join, dist_join.price_plan_candidate, []

        def priced(*a, **k):
            price, probe = self.orig(*a, **k)
            odf = a[7].over_decom_factor

            def counted():
                before = read_launches()
                s = probe()
                after = read_launches()
                self.runs.append({"odf": odf, "seconds": s,
                                  "launches": {n: after[n] - before[n] for n in after}})
                return s

            return price, counted

        dist_join.price_plan_candidate = priced
        return self

    def __exit__(self, *exc):
        self.mod.price_plan_candidate = self.orig


def roofline_line(what: str, model: int, runs: list) -> dict:
    wall = statistics.median(runs)
    return {"case": what, "model_bytes": model, "wall_ms": wall, "wall_ms_runs": runs,
            "model_gbps": model / (wall * 1e-3) / 1e9,
            "model_bytes_over_wall_over_hbm": model / (wall * 1e-3) / HBM_BYTES_PER_S}


def run_byte_model(dj, dev, topo, left, lcnt, right, rcnt, rows: int, expected: int,
                   smi: str) -> dict:
    """Phase 13(a): phase 4's one-rank join warm at odf 1 and 4 and phase
    5's prepared queries under each merge tier at odf 1, each with
    hbm_model_bytes of the plan it ran, its median wall of 3 and model
    bytes / wall / 3.35 TB/s; prepared_side_bytes of phase 5's side
    beside the growth of torch.cuda.memory_allocated() across its
    prepare."""
    from dj_tpu_torch.obs import bytemodel
    from dj_tpu_torch.ops.join import JoinPlan, join_plan
    from dj_tpu_torch.parallel import dist_join as dist

    out = {}
    for odf in PHASE13_ODFS:
        cfg = dj.JoinConfig(over_decom_factor=odf)
        kr = dist._resolve_key_range(cfg, left, lcnt, right, rcnt, [0], [0], 1, topo)
        plan = join_plan(left, right, [0], [0], kr)
        model = bytemodel.hbm_model_bytes(rows, odf, cfg, expected, plan)
        _, runs, peak = warm_walls(lambda: dj.distributed_inner_join(
            topo, left, lcnt, right, rcnt, [0], [0], cfg))
        out[f"join_odf{odf}"] = line = roofline_line(f"join odf={odf}", model, runs)
        line.update(plan=list(bytemodel.model_plan(plan)), peak_bytes=peak)
        log("byte_model", smoke_phase="13a", **line, card=smi)
    cfg = dj.JoinConfig(over_decom_factor=1, key_range=(0, 2 * rows))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    prep = dj.prepare_join_side(topo, right, rcnt, [0], cfg, left_capacity=rows)
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - before
    side = bytemodel.prepared_side_bytes(prep)
    out["prepared_side"] = {"prepared_side_bytes": side, "memory_allocated_growth": grew,
                            "ratio": side / grew if grew else None}
    log("byte_model", smoke_phase="13a", case="prepared_side", **out["prepared_side"], card=smi)
    for tier in TIERS:
        with env_set(DJT_JOIN_MERGE=tier):
            model = bytemodel.hbm_model_bytes(rows, 1, cfg, expected, JoinPlan("vmeta", True, False),
                                              prepared=True, merge_impl=tier)
            _, runs, peak = warm_walls(lambda: dj.distributed_inner_join(
                topo, left, lcnt, prep, None, [0], None, cfg))
        out[f"prepared_{tier}"] = line = roofline_line(f"prepared tier={tier}", model, runs)
        line["peak_bytes"] = peak
        log("byte_model", smoke_phase="13a", **line, card=smi)
    del prep
    torch.cuda.empty_cache()
    return out


def run_truth(dev, smi: str) -> dict:
    """Phase 13(b): sample_device_hbm with obs on gives device 0, its
    bytes_in_use torch.cuda.memory_allocated(0) at that moment, its peak
    at least that, its limit the card's total memory, and both gauges;
    measured_admission(80e9) under DJT_SERVE_MEASURED_HBM=1 gives budget
    - in use - margin."""
    from dj_tpu_torch.obs import truth

    torch.cuda.synchronize()
    with obs_on() as obs:
        sample = truth.sample_device_hbm()
        allocated = torch.cuda.memory_allocated(0)
        total = torch.cuda.get_device_properties(0).total_memory
        s0 = (sample or {}).get("0")
        if s0 is None or s0["bytes_in_use"] != allocated or \
                s0["peak_bytes_in_use"] < s0["bytes_in_use"] or s0["bytes_limit"] != total:
            raise AssertionError(f"13b: sample {sample}, memory_allocated {allocated}, "
                                 f"total {total}")
        gauges = {g: obs.gauge_value(g, device="0")
                  for g in ("dj_device_hbm_in_use_bytes", "dj_device_hbm_peak_bytes")}
        if gauges["dj_device_hbm_in_use_bytes"] != allocated or \
                gauges["dj_device_hbm_peak_bytes"] != s0["peak_bytes_in_use"]:
            raise AssertionError(f"13b: gauges {gauges}, sample {s0}")
        margin = 1e9
        with env_set(DJT_SERVE_MEASURED_HBM="1", DJT_SERVE_MEASURED_HBM_HEADROOM=str(margin)):
            adm = truth.measured_admission(80e9)
        want = 80e9 - adm["bytes_in_use"] - margin
        if adm["device"] != "0" or adm["headroom_bytes"] != want or \
                adm["bytes_in_use"] != torch.cuda.memory_allocated(0):
            raise AssertionError(f"13b: admission {adm}, expected headroom {want}")
        summary = truth.truth_summary()
    out = {"sample": sample, "memory_allocated": allocated, "total_memory": total,
           "mem_get_info_total": torch.cuda.mem_get_info(0)[1],
           "gauges": gauges, "admission": adm,
           "summary_measured_peak": summary["measured_peak_hbm_bytes"]}
    log("truth", smoke_phase="13b", **out, card=smi)
    return out


def skew_query(what: str, join, odf: int, obs) -> dict:
    """One query with the skew probe armed: its partition-count passes,
    skew events and result."""
    obs.drain()
    with CountPasses() as passes:
        res = join()
        torch.cuda.synchronize()
    evs = obs.events("skew")
    if len(evs) != odf:
        raise AssertionError(f"13c {what}: {len(evs)} skew events, expected one a batch ({odf})")
    return {"passes": passes.n, "ratios": [e["ratio"] for e in evs],
            "max_rows": [e["max_rows"] for e in evs], "res": res}


def run_skew(dj, dev, build, probe, rows: int, smi: str) -> dict:
    """Phase 13(c): the skew probe in 4d's world (module docstring)."""
    from dj_tpu_torch.obs import skew
    from dj_tpu_torch.resilience import ledger

    topo = dj.make_topology([dev] * WORLD)
    left, lcnt = dj.shard_table(topo, probe)
    right, rcnt = dj.shard_table(topo, build)
    out: dict = {}
    uniform_ratio = 0.0
    with obs_on() as obs:
        for odf in PHASE13_ODFS:
            cfg = dj.JoinConfig(over_decom_factor=odf)

            def join():
                return dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)

            obs.reset()
            with env_set(DJT_OBS_SKEW="1"):
                q = skew_query(f"odf={odf}", join, odf, obs)
                flags_false(f"13c odf={odf}", q.pop("res")[2])
                wm = skew.wire_matrix()
                sent = sum(obs.counter_series("dj_collective_bytes_total").values())
                if q["passes"] != 1 or wm["n"] != WORLD or \
                        any(abs(t - sent) > 1e-6 * sent for t in wm["row_totals"]):
                    raise AssertionError(f"13c odf={odf}: passes {q['passes']}, wire rows "
                                         f"{wm['row_totals']} vs collective bytes {sent}")
                on, on_runs, _ = warm_walls(join)
            off, off_runs, _ = warm_walls(join)
            uniform_ratio = max(uniform_ratio, *q["ratios"])
            out[f"uniform_odf{odf}"] = {**q, "wire_row_totals": wm["row_totals"],
                                        "collective_bytes": sent, "wall_ms_probe_on": on,
                                        "wall_ms_probe_off": off, "wall_ms_runs_on": on_runs,
                                        "wall_ms_runs_off": off_runs}
            log("skew", smoke_phase="13c", case="uniform", odf=odf, ranks=WORLD,
                **out[f"uniform_odf{odf}"], card=smi)
        # DJT_OBS_SKEW_EVERY=4: four calls of one signature probe once.
        cfg = dj.JoinConfig()
        with env_set(DJT_OBS_SKEW="1", DJT_OBS_SKEW_EVERY="4"), CountPasses() as passes:
            skew._clear()
            for _ in range(4):
                res = dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)
                del res
        if passes.n != 1:
            raise AssertionError(f"13c: DJT_OBS_SKEW_EVERY=4 probed {passes.n} times in 4 calls")
        out["every_4"] = {"calls": 4, "passes": passes.n}
        # 4i(ii)'s skewed probe side under DJT_PLAN_ADAPT=1: each query
        # (each heal attempt) one pass, shared by the skew probe and the plan.
        keys = probe.columns[0].data.clone()
        g = torch.Generator(device=keys.device).manual_seed(14)
        hot_rows = torch.rand(keys.numel(), generator=g, device=keys.device) < HOT_PROBE_SHARE
        keys[hot_rows] = build.columns[0].data[7]
        del hot_rows
        hot = dj.Table((dj.Column(keys, dj.dtypes.int64), probe.columns[1]))
        hot_expected = key_matches(build.columns[0].data, keys)
        del keys
        hl, hlc = dj.shard_table(topo, hot)
        ledger.reset()
        obs.drain()
        with env_set(DJT_OBS_SKEW="1", DJT_PLAN_ADAPT="1", DJT_BROADCAST_BYTES="0"), \
                CountPasses() as passes, Attempts() as a:
            res = dj.distributed_inner_join_auto(topo, hl, hlc, right, rcnt, [0], [0],
                                                 dj.JoinConfig())
            torch.cuda.synchronize()
        flags_false("13c skewed", res[2])
        if int(res[1].sum()) != hot_expected:
            raise AssertionError(f"13c skewed: {int(res[1].sum())} rows, expected {hot_expected}")
        del res
        evs = obs.events("skew")
        plans = obs.events("plan_adapt")
        ratios = [e["ratio"] for e in evs]
        if passes.n != a.n or len(evs) != a.n or not plans or plans[0]["tier"] != "salted" \
                or min(ratios) <= uniform_ratio:
            raise AssertionError(f"13c skewed: {passes.n} passes and {len(evs)} skew events in "
                                 f"{a.n} queries, plans {plans}, ratios {ratios} vs uniform "
                                 f"{uniform_ratio}")
        out["skewed_odf1"] = {"queries": a.n, "passes": passes.n, "ratios": ratios,
                              "uniform_max_ratio": uniform_ratio, "plan": plans[0]["tier"],
                              "salt": plans[0].get("salt"), "total": hot_expected}
        log("skew", smoke_phase="13c", case="skewed", odf=1, ranks=WORLD, **out["skewed_odf1"],
            every_4=out["every_4"], card=smi)
    ledger.reset()
    del hl, hlc, hot, left, right
    torch.cuda.empty_cache()
    return out


def run_autotune(dj, dev, build, probe, expected: int, ref, rows: int, smi: str) -> dict:
    """Phase 13(d): the autotuner on 4j's two-stage chain in 4d's world at
    odf 1 through distributed_join_pipeline_auto (module docstring).
    Returns {path: {odf: launches}} of the world."""
    from dj_tpu_torch.parallel import autotune
    from dj_tpu_torch.resilience import errors, faults, ledger

    topo = dj.make_topology([dev] * WORLD)
    left, lcnt, right, rcnt, b2, b2c = chain_tables(dj, topo, build, probe)
    stages = chain_stages(dj, right, rcnt, b2, b2c)
    cfg = dj.JoinConfig(over_decom_factor=1)
    table: dict = {}

    def chain(c=cfg):
        return dj.distributed_join_pipeline_auto(topo, left, lcnt, stages, c)

    def rows_of(what, res):
        for i, info in enumerate(res[2]):
            flags_false(f"{what} stage {i}", info)
        check_same_rows(chain_rows(what, dj, res[0], res[1], build, probe, expected), ref, what)

    autotune._clear()
    ledger.reset()
    untuned, untuned_runs, untuned_peak = warm_walls(chain)
    with tempfile.TemporaryDirectory() as tmp, obs_on() as obs, \
            env_set(DJT_AUTOTUNE="1", DJT_LEDGER=os.path.join(tmp, "ledger.jsonl")):
        # The first call tunes: every candidate priced, two probed.
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with Probes() as probes:
            t0 = time.perf_counter()
            res = chain()
            torch.cuda.synchronize()
            tune_wall = (time.perf_counter() - t0) * 1e3
        tune_peak = torch.cuda.max_memory_allocated()
        tune_launches = read_launches()
        rows_of("13d tuning call", res)
        del res
        tunes = obs.events("tune")
        if len(tunes) != 1 or tunes[0]["action"] != "tune" or len(probes.runs) != 2:
            raise AssertionError(f"13d: tune events {tunes}, {len(probes.runs)} probes")
        # The event's sig is cut at 200 characters; the tuner's view has it whole.
        ((sig, tuned),) = autotune.tunez_summary()["signatures"].items()
        evidence = tuned["candidates"]
        n_cands = len(autotune._candidate_space(cfg, prepared=False, sig=sig))
        if len(evidence) != n_cands or tunes[0]["candidates"] != n_cands or \
                any(c.get("infeasible") or not c.get("bytes_accessed") for c in evidence):
            raise AssertionError(f"13d: evidence {evidence} of {n_cands} candidates")
        winner = tunes[0]["odf"] or cfg.over_decom_factor
        table["autotune_chain_tuning"] = {1: tune_launches}
        table["autotune_probes"] = {p["odf"]: p["launches"] for p in probes.runs}
        # The second call replays the decision: no probe, the launches of an
        # untuned call at the winner's odf.
        reset_launches()
        with Probes() as again:
            res = chain()
            torch.cuda.synchronize()
        replay_launches = read_launches()
        rows_of("13d second call", res)
        del res
        replay, replay_runs, _ = warm_walls(chain)
        with env_set(DJT_AUTOTUNE="0"):
            reset_launches()
            res = chain(dj.JoinConfig(over_decom_factor=winner))
            torch.cuda.synchronize()
            want_launches = read_launches()
            del res
        if again.runs or len(obs.events("tune")) != 1 or replay_launches != want_launches:
            raise AssertionError(f"13d second call: {len(again.runs)} probes, launches "
                                 f"{replay_launches} vs untuned odf {winner} {want_launches}")
        table["autotune_chain_replay"] = {winner: replay_launches}
        # A restart: the tuner and the in-process ledger forgotten, the file kept.
        autotune._clear()
        ledger.reset()
        obs.drain()
        with Probes() as restart:
            res = chain()
            torch.cuda.synchronize()
        rows_of("13d restart", res)
        del res
        replays = [e["action"] for e in obs.events("tune")]
        if restart.runs or replays != ["replay"]:
            raise AssertionError(f"13d restart: tune events {replays}, {len(restart.runs)} probes")
    # Stage 0 alone at each candidate's odf, untuned (the probes'
    # dispatch, median of 3): did the two cheapest by bytes hold the
    # fastest?
    stage0 = {}
    for o in sorted({c.get("odf") or cfg.over_decom_factor for c in evidence}):
        c0 = dj.JoinConfig(over_decom_factor=o)
        stage0[o] = warm_walls(lambda: dj.distributed_inner_join(topo, left, lcnt, right, rcnt,
                                                                 [0], [0], c0))[0]
    fastest = min(stage0, key=stage0.get)
    # A faulted probe inside the caller's guard: one degrade, the retry
    # serves the defaults.
    autotune._clear()
    ledger.reset()
    with obs_on() as obs, env_set(DJT_AUTOTUNE="1"):
        faults.configure("autotune_probe@call=1")
        res = errors.degrade_guard("phase 13(d)", chain, tiers=("autotune",))
        torch.cuda.synchronize()
        rows_of("13d faulted probe", res)
        del res
        degrades = obs.events("degrade")
        pins = errors.pinned_tiers()
        if [e["tier"] for e in degrades] != ["autotune"] or list(pins) != ["autotune"] or \
                autotune.enabled():
            raise AssertionError(f"13d fault: degrades {degrades}, pins {pins}")
        faults.reset()
        errors.reset_pins()
    autotune._clear()
    ledger.reset()
    out = {"candidates": evidence, "winner_odf": winner, "probes": probes.runs,
           "wall_ms_untuned": untuned, "wall_ms_runs_untuned": untuned_runs,
           "peak_bytes_untuned": untuned_peak, "wall_ms_tuning_call": tune_wall,
           "peak_bytes_tuning_call": tune_peak, "wall_ms_replayed": replay,
           "wall_ms_runs_replayed": replay_runs, "launches_tuning_call": tune_launches,
           "launches_replayed": replay_launches, "restart_replay_events": 1,
           "fault_degrades": 1, "winner_slower_than_default": replay > untuned,
           "stage0_wall_ms_by_odf": stage0, "fastest_odf": fastest,
           "fastest_odf_probed": fastest in {p["odf"] for p in probes.runs}}
    log("autotune", smoke_phase="13d", ranks=WORLD, odf=1, rows=rows, **out, card=smi)
    del left, right, b2, stages
    torch.cuda.empty_cache()
    return table


# --- the join-index cache and fleet coordination (phase 14) ------------------


@contextlib.contextmanager
def counted_calls(module, name: str):
    """Calls of ``module.name`` inside the block: yields a one-item list
    that holds the count."""
    real = getattr(module, name)
    box = [0]

    def counted(*a, **k):
        box[0] += 1
        return real(*a, **k)

    setattr(module, name, counted)
    try:
        yield box
    finally:
        setattr(module, name, real)


def allocated() -> int:
    """torch.cuda.memory_allocated() after a synchronize."""
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def pool_stats() -> dict:
    """The caching allocator's current bytes, blocks and segments by pool
    (``torch.cuda.memory_stats()``): what memory_allocated() sums, and
    what the callers asked for (``requested_bytes``) beside it."""
    st = torch.cuda.memory_stats()
    return {k: st.get(f"{k}.current", 0) for k in (
        "allocated_bytes.all", "requested_bytes.all", "allocated_bytes.large_pool",
        "allocated_bytes.small_pool", "active.all", "segment.all", "reserved_bytes.all")}


def index_query(what: str, dj, topo, left, lcnt, side, cfg, build, probe, expected: int,
                ref, *, w: int = 1, kernels=None):
    """One query of a cached side: flags False, the rows checked against
    ``build`` / ``probe`` and (``ref`` given) equal to the default join's,
    a world's rows on their hash's shard, and each of ``kernels``
    launched w times a batch. Returns the query's launches."""
    reset_launches()
    out, counts, info = dj.distributed_inner_join(topo, left, lcnt, side, None, [0], None, cfg)
    torch.cuda.synchronize()
    launches = read_launches()
    flags_false(what, info)
    if w > 1:
        check_colocated(what, out, counts, cfg.over_decom_factor)
        out = dj.unshard_table(out, counts)
    counts = torch.tensor([int(counts.sum())])
    check_rows(out, counts, build, probe, expected)
    if ref is not None:
        check_same_rows(sorted_rows(out, counts), ref, what)
    want = w * cfg.over_decom_factor
    wrong = {k: launches[k] for k in kernels or () if launches[k] != want}
    if wrong:
        raise AssertionError(f"{what}: each of {kernels} must launch {want} times: {wrong}")
    return launches


def run_index_cache(dj, dev, topo, left, lcnt, right, rcnt, build, probe, expected: int,
                    ref, rows: int, prep_ms: float, query_ms: dict, smi: str) -> tuple:
    """Phase 14: the join-index cache and fleet coordination on phase 5's
    build side (module docstring). ``prep_ms`` is phase 5's warm prepare
    at odf 1 and ``query_ms`` its warm queries by tier. Returns ({path:
    {odf: launches}} of one rank, the same of 4d's world)."""
    from dj_tpu_torch import cache as djcache
    from dj_tpu_torch import fleet
    from dj_tpu_torch.cache import index as cache_index
    from dj_tpu_torch.obs import bytemodel
    from dj_tpu_torch.ops.join import prepared_effective_plan
    from dj_tpu_torch.parallel import dist_join as dist
    from dj_tpu_torch.parallel import plan_adapt
    from dj_tpu_torch.resilience import errors, ledger

    t_phase = time.perf_counter()
    one_rank: dict = {}
    world: dict = {}
    on_card = torch.device(dev).type == "cuda"
    cfg1 = dj.JoinConfig(key_range=(0, 2 * rows))
    djcache.reset()

    def get(cache, t=topo, r=(right, rcnt), cfg=cfg1, **kw):
        return cache.get_or_prepare(t, *r, [0], cfg, left_capacity=rows, **kw)

    # (a) one rank: the miss prepares once, the hit is free, resident bytes
    # are the side's, a query through the lease under each tier.
    cache = djcache.JoinIndexCache(djcache.IndexConfig())
    before = allocated()
    t0 = time.perf_counter()
    lease = get(cache, tenant="a")
    torch.cuda.synchronize()
    miss_ms = (time.perf_counter() - t0) * 1e3
    grew = allocated() - before
    side_bytes = bytemodel.prepared_side_bytes(lease.prepared)
    if cache.resident_bytes != side_bytes or djcache.resident_bytes() != side_bytes:
        raise AssertionError(f"14a: resident {cache.resident_bytes} != side {side_bytes}")
    reset_launches()
    with counted_calls(dist, "run_spmd") as spmd_calls, Collectives() as coll:
        t0 = time.perf_counter()
        hit = get(cache, tenant="a")
        torch.cuda.synchronize()
        hit_ms = (time.perf_counter() - t0) * 1e3
    hit_launches = read_launches()
    if hit.prepared is not lease.prepared or any(hit_launches.values()) or spmd_calls[0] or \
            any(coll.counts.values()):
        raise AssertionError(f"14a: the hit launched {hit_launches}, {spmd_calls[0]} "
                             f"dispatches, collectives {coll.counts}")
    hit.release()
    walls = {}
    for tier in TIERS:
        with env_set(DJT_JOIN_MERGE=tier):
            what = f"14a tier={tier}"
            one_rank[f"index_prepared_{tier}"] = {1: index_query(
                what, dj, topo, left, lcnt, lease.prepared, cfg1, build, probe, expected, ref,
                kernels=prepared_effective_plan(tier))}
            walls[tier] = warm_walls(lambda: dj.distributed_inner_join(
                topo, left, lcnt, lease.prepared, None, [0], None, cfg1))[0]
    lease.release()
    log("index_cache", smoke_phase="14", case="(a)", ranks=1, odf=1, rows=rows,
        miss_wall_ms=miss_ms, phase5_warm_prepare_ms=prep_ms, hit_wall_ms=hit_ms,
        hit_launches=hit_launches, hit_dispatches=0, hit_collectives=coll.counts,
        resident_bytes=side_bytes, memory_allocated_growth=grew,
        resident_over_growth=side_bytes / grew if grew else None,
        query_wall_ms=walls, phase5_query_wall_ms={t: query_ms[(1, t)] for t in TIERS},
        launches={t: one_rank[f"index_prepared_{t}"][1] for t in TIERS}, card=smi)
    cache.clear()
    del lease, hit
    torch.cuda.empty_cache()

    # (b) the budget: 1.5 entries evict the LRU unpinned one; 2.5 entries
    # with both pinned reject a third, typed, and keep the residency.
    with env_set(DJT_INDEX_HBM_BUDGET=str(1.5 * side_bytes)), obs_on() as obs:
        cache = djcache.JoinIndexCache()
        a = get(cache, tenant="a")
        a.release()
        gc.collect()
        held = {id(o) for o in gc.get_objects() if isinstance(o, torch.Tensor)}
        m0, s0 = allocated(), pool_stats()
        b = get(cache, tenant="b")
        m1, s1 = allocated(), pool_stats()
        evicts = [e for e in obs.events("index") if e["op"] == "evict"]
        b_bytes = cache.resident_bytes
        # b adds one side of a's size and evicts a: the allocator stays flat.
        insert_change = m1 - m0
        b.release()
        freed = cache.shed_bytes(float("inf"))
        m2, s2 = allocated(), pool_stats()
        drop_b = m1 - m2
        if [e["tenant"] for e in evicts] != ["a"] or cache.entry_count != 0 or \
                freed != b_bytes:
            raise AssertionError(f"14b: evicts {evicts}, entries {cache.entry_count}, "
                                 f"freed {freed} of {b_bytes}")
        # memory_allocated() counts whole blocks: the large pool rounds a
        # block to 512 bytes and leaves a remainder of up to 1 MiB unsplit,
        # so each of the side's blocks may hold that much beyond its
        # tensor. That residue does not grow with the side; the bytes the
        # callers asked for (requested_bytes) must move by the side alone.
        blocks = s1["active.all"] - s2["active.all"]
        residue = blocks * (2**20 + 512)
        asked = s1["requested_bytes.all"] - s2["requested_bytes.all"]
        if on_card and not (abs(insert_change) <= 0.01 * side_bytes + residue
                            and abs(drop_b - b_bytes) <= 0.01 * b_bytes + residue
                            and abs(asked - b_bytes) <= 0.01 * b_bytes):
            gc.collect()
            print_holders(held)
            raise AssertionError(f"14b: the allocator moved {insert_change} bytes across an "
                                 f"insert that evicted a side of {side_bytes}, and dropped "
                                 f"{drop_b} ({asked} requested, {blocks} blocks) for a shed "
                                 f"side of {b_bytes}")
    with env_set(DJT_INDEX_HBM_BUDGET=str(2.5 * side_bytes)), obs_on() as obs:
        cache = djcache.JoinIndexCache()
        x, y = get(cache, tenant="x"), get(cache, tenant="y")
        resident, m3 = cache.resident_bytes, allocated()
        try:
            get(cache, tenant="z")
        except dj.AdmissionRejected as e:
            rejected = {"budget_bytes": e.budget_bytes, "forecast_bytes": e.forecast_bytes,
                        "reserved_bytes": e.reserved_bytes}
        else:
            raise AssertionError("14b: a third entry beside two pinned ones was admitted")
        m4 = allocated()
        if cache.resident_bytes != resident or obs.counter_value("dj_index_evict_total") or \
                sorted(v["tenant"] for v in cache.stats().values()) != ["x", "y"]:
            raise AssertionError(f"14b: the reject changed the residency: {cache.stats()}")
        x.release()
        y.release()
        cache.clear()
    log("index_cache", smoke_phase="14", case="(b)", budget_entries=1.5, entry_bytes=side_bytes,
        evicted=[e["tenant"] for e in evicts], allocator_change_across_evicting_insert=insert_change,
        allocator_drop_on_shed=drop_b, requested_drop_on_shed=asked, shed_blocks=blocks,
        block_residue_bound=residue, pool_before_insert=s0, pool_after_insert=s1,
        pool_after_shed=s2, shed_bytes=freed, pinned_budget_entries=2.5,
        rejected=rejected, resident_bytes_kept=resident,
        allocator_after_reject_minus_before=m4 - m3, card=smi)
    del a, b, x, y
    torch.cuda.empty_cache()

    # (c) appends through the cache at odf 4: 5c's 1% rows incrementally,
    # then rows past the anchored range through one re-prepare.
    cfg4 = dj.JoinConfig(over_decom_factor=4, key_range=(0, 2 * rows))
    cache = djcache.JoinIndexCache()
    lease = get(cache, cfg=cfg4, tenant="append")
    n_app = max(1, rows // 100)
    gen = torch.Generator(device=dev).manual_seed(14)
    keys = absent_keys(gen, dev, build.columns[0].data, 2 * rows, n_app)
    app = appended_table(dj, keys, build.capacity)
    combined = dj.concatenate([build, app]).with_count(None)
    total = expected + appended_matches(probe, keys)
    del keys
    with obs_on() as obs:
        t0 = time.perf_counter()
        cache.append_rows(lease.key, *dj.shard_table(topo, app))
        torch.cuda.synchronize()
        append_ms = (time.perf_counter() - t0) * 1e3
        ops = [e["op"] for e in obs.events("index")]
        touched = [e.get("touched") for e in obs.events("index")]
    if ops != ["append"]:
        raise AssertionError(f"14c: the in-range append recorded {ops}")
    fresh = dj.prepare_join_side(topo, *dj.shard_table(topo, combined), [0], cfg4,
                                 left_capacity=rows)
    out, counts, _ = dj.distributed_inner_join(topo, left, lcnt, fresh, None, [0], None, cfg4)
    fresh_rows = sorted_rows(out, counts)
    del out, counts, fresh
    for tier in TIERS:
        with env_set(DJT_JOIN_MERGE=tier):
            one_rank[f"index_append_{tier}"] = {4: index_query(
                f"14c append tier={tier}", dj, topo, left, lcnt, lease.prepared, cfg4, combined,
                probe, total, fresh_rows, kernels=prepared_effective_plan(tier))}
    # Past the packed word's key field (the next power of two above the
    # declared range), which the anchored plan holds.
    far = appended_table(dj, 8 * rows + torch.arange(1000, device=dev), combined.capacity)
    combined = dj.concatenate([combined, far]).with_count(None)
    with obs_on() as obs:
        t0 = time.perf_counter()
        cache.append_rows(lease.key, *dj.shard_table(topo, far))
        torch.cuda.synchronize()
        reprepare_ms = (time.perf_counter() - t0) * 1e3
        ops = [e["op"] for e in obs.events("index")]
    healed = lease.prepared
    if ops != ["reprepare"] or healed.key_range[0][1] != 8 * rows + 999:
        raise AssertionError(f"14c: the escaping append recorded {ops}, range "
                             f"{healed.key_range}")
    one_rank["index_append_reprepared_sort"] = {4: index_query(
        "14c escaping append", dj, topo, left, lcnt, healed, healed.config, combined, probe,
        total, fresh_rows, kernels=prepared_effective_plan("sort"))}
    log("index_cache", smoke_phase="14", case="(c)", odf=4, appended_rows=n_app,
        touched=touched, append_wall_ms=append_ms, total=total, rows_checked=total,
        same_rows_as_fresh_prepare=True, escaping_rows=1000, reprepare_events=1,
        reprepare_wall_ms=reprepare_ms, key_range=healed.key_range,
        resident_bytes=cache.resident_bytes, card=smi)
    lease.release()
    cache.clear()
    del lease, healed, app, far, combined, fresh_rows
    torch.cuda.empty_cache()

    # (d) warm restart from the manifest, then warmup_join_index.
    with tempfile.TemporaryDirectory() as tmp, \
            env_set(DJT_INDEX_MANIFEST=os.path.join(tmp, "index.jsonl")):
        cache = djcache.JoinIndexCache()
        get(cache, tenant="a", name="build").release()
        cache.clear()
        restarted = djcache.JoinIndexCache()
        with obs_on() as obs:
            t0 = time.perf_counter()
            restored = restarted.warm_restart(
                lambda rec: {"topology": topo, "right": right, "right_counts": rcnt})
            torch.cuda.synchronize()
            restart_ms = (time.perf_counter() - t0) * 1e3
            restores = [e for e in obs.events("index") if e["op"] == "restore"]
            t0 = time.perf_counter()
            warmed = dj.warmup_join_index(topo, restarted, left, lcnt, [0], cfg1)
            warmup_ms = (time.perf_counter() - t0) * 1e3
        if restored != 1 or len(restores) != 1 or warmed != 1:
            raise AssertionError(f"14d: restored {restored}, {len(restores)} restore "
                                 f"events, warmed {warmed}")
        with get(restarted, tenant="a", name="build") as lease:
            t0 = time.perf_counter()
            res = dj.distributed_inner_join(topo, left, lcnt, lease.prepared, None, [0], None,
                                            cfg1)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            del res
            warm, warm_runs, _ = warm_walls(lambda: dj.distributed_inner_join(
                topo, left, lcnt, lease.prepared, None, [0], None, cfg1))
        restarted.clear()
    log("index_cache", smoke_phase="14", case="(d)", restored=restored,
        restore_events=len(restores), restart_wall_ms=restart_ms, warmed=warmed,
        warmup_wall_ms=warmup_ms, first_query_wall_ms=first_ms, warm_query_wall_ms=warm,
        warm_query_wall_ms_runs=warm_runs, card=smi)
    del lease
    torch.cuda.empty_cache()

    # (e) 4d's world: a cached side, a free hit, each tier's rows on their
    # shard; the broadcast fit against the budget less the resident bytes.
    topo4 = dj.make_topology([dev] * WORLD)
    left4, lcnt4 = dj.shard_table(topo4, probe)
    right4, rcnt4 = dj.shard_table(topo4, build)
    cache = djcache.JoinIndexCache()
    lease = get(cache, t=topo4, r=(right4, rcnt4), tenant="world")
    reset_launches()
    with counted_calls(dist, "run_spmd") as spmd_calls, Collectives() as hit_coll:
        hit = get(cache, t=topo4, r=(right4, rcnt4), tenant="world")
        torch.cuda.synchronize()
    hit_launches = read_launches()
    if hit.prepared is not lease.prepared or any(hit_launches.values()) or spmd_calls[0] or \
            any(hit_coll.counts.values()):
        raise AssertionError(f"14e: the hit launched {hit_launches}, {spmd_calls[0]} "
                             f"dispatches, collectives {hit_coll.counts}")
    hit.release()
    for tier in TIERS:
        with env_set(DJT_JOIN_MERGE=tier):
            world[f"index_world_{tier}"] = {1: index_query(
                f"14e tier={tier}", dj, topo4, left4, lcnt4, lease.prepared, cfg1, build, probe,
                expected, ref, w=WORLD, kernels=prepared_effective_plan(tier))}
    lease.release()
    resident = djcache.resident_bytes()
    rb = float(dist._global_table_bytes(topo4, right4))
    budget = rb + resident - 1.0  # fits the side alone, not beside the entry
    cfg0 = dj.JoinConfig()
    with env_set(DJT_PLAN_ADAPT="1", DJT_BROADCAST_BYTES=repr(budget)):
        available = plan_adapt.available_broadcast_bytes()
        if available != budget - resident or resident != cache.resident_bytes:
            raise AssertionError(f"14e: available {available}, budget {budget}, resident "
                                 f"{resident}")
        ledger.reset()
        d = dist._resolve_plan_decision(topo4, left4, lcnt4, right4, rcnt4, (0,), (0,), cfg0)
        if d.tier != "shuffle":
            raise AssertionError(f"14e: with the entry resident the plan is {d}")
        reset_launches()
        with Collectives() as coll:
            out, counts, info = dj.distributed_inner_join(topo4, left4, lcnt4, right4, rcnt4,
                                                          [0], [0], cfg0)
            torch.cuda.synchronize()
        world["index_world_plan_shuffle"] = {1: read_launches()}
        flags_false("14e shuffle plan", info)
        if not coll.counts["all_to_all_start"]:
            raise AssertionError(f"14e: the shuffle plan issued no all-to-all: {coll.counts}")
        check_colocated("14e shuffle plan", out, counts, 1)
        flat = dj.unshard_table(out, counts)
        flat_counts = torch.tensor([flat.capacity])
        check_rows(flat, flat_counts, build, probe, expected)
        check_same_rows(sorted_rows(flat, flat_counts), ref, "14e shuffle plan")
        del out, counts, info, flat
        cache.clear()
        ledger.reset()
        d_empty = dist._resolve_plan_decision(topo4, left4, lcnt4, right4, rcnt4, (0,), (0,),
                                              cfg0)
        if (d_empty.tier, d_empty.source) != ("broadcast", "fit"):
            raise AssertionError(f"14e: with the cache empty the plan is {d_empty}")
        ledger.reset()
    log("index_cache", smoke_phase="14", case="(e)", ranks=WORLD, odf=1, hit_launches=hit_launches,
        hit_collectives=hit_coll.counts, shuffle_plan_collectives=coll.counts,
        resident_bytes=resident, replicated_side_bytes=rb,
        broadcast_bytes=budget, available_broadcast_bytes=available,
        decision_with_entry=[d.tier, d.source], decision_without=[d_empty.tier, d_empty.source],
        launches={k: v[1] for k, v in world.items()}, rows_checked=expected, colocated=True,
        card=smi)
    del lease, hit, left4, right4
    torch.cuda.empty_cache()

    # (f) the fleet tier: the prepare lease released after the manifest's
    # insert line, then a faulted lease degrading once to a local build.
    with tempfile.TemporaryDirectory() as tmp, \
            env_set(DJT_FLEET_DIR=os.path.join(tmp, "fleet"),
                    DJT_INDEX_MANIFEST=os.path.join(tmp, "index.jsonl")), obs_on() as obs:
        leases_at_line = []
        real_append = cache_index.dj_ledger.append_line

        def append_line(path, rec):
            leases_at_line.append(sorted(os.listdir(os.path.join(tmp, "fleet", "leases"))))
            real_append(path, rec)

        cache_index.dj_ledger.append_line = append_line
        try:
            cache = djcache.JoinIndexCache()
            lease = get(cache, tenant="f", name="fleet")
        finally:
            cache_index.dj_ledger.append_line = real_append
        with open(os.path.join(tmp, "index.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        left_after = os.listdir(os.path.join(tmp, "fleet", "leases"))
        if len(leases_at_line) != 1 or len(leases_at_line[0]) != 1 or left_after or \
                [(r["op"], r["pid"], r["host"]) for r in lines] != [
                    ("insert", os.getpid(), socket.gethostname())]:
            raise AssertionError(f"14f: leases at the line {leases_at_line}, after "
                                 f"{left_after}, manifest {lines}")
        with env_set(DJT_JOIN_MERGE="sort"):
            one_rank["index_fleet_sort"] = {1: index_query(
                "14f fleet", dj, topo, left, lcnt, lease.prepared, cfg1, build, probe, expected,
                ref, kernels=prepared_effective_plan("sort"))}
        lease.release()
        cache.clear()
        with env_set(DJT_FAULT="fleet.lease_acquire@call=1"):
            local = djcache.JoinIndexCache(djcache.IndexConfig())
            lease = get(local, tenant="g")
            degrades = obs.events("degrade")
            pins = errors.pinned_tiers()
            if [e["tier"] for e in degrades] != ["fleet"] or list(pins) != ["fleet"] or \
                    fleet.enabled() or os.listdir(os.path.join(tmp, "fleet", "leases")):
                raise AssertionError(f"14f: degrades {degrades}, pins {pins}")
            with env_set(DJT_JOIN_MERGE="sort"):
                one_rank["index_fleet_degraded_sort"] = {1: index_query(
                    "14f degraded", dj, topo, left, lcnt, lease.prepared, cfg1, build, probe,
                    expected, ref, kernels=prepared_effective_plan("sort"))}
            lease.release()
            local.clear()
            errors.reset_pins()
            from dj_tpu_torch.resilience import faults

            faults.reset()
    log("index_cache", smoke_phase="14", case="(f)", manifest_line={k: lines[0][k] for k in
                                                               ("op", "tenant", "name", "odf")},
        lease_held_at_the_line=True, leases_after=0, degrades=[e["tier"] for e in degrades],
        pinned=list(pins), launches={k: one_rank[k][1] for k in
                                     ("index_fleet_sort", "index_fleet_degraded_sort")}, card=smi)
    del lease
    djcache.reset()
    torch.cuda.empty_cache()
    log("index_cache_phase", smoke_phase="14", seconds=time.perf_counter() - t_phase, card=smi)
    return one_rank, world


# --- admission and the query scheduler (phase 15) ----------------------------


CARD_BYTES = 85_017_493_504  # the H100 80GB HBM3's total_memory


def served(s, submit_args):
    """Submit one query to scheduler ``s`` and wait for it: (payload, wall
    ms from submit to the caller's stream ordered after the result, the
    ticket)."""
    t0 = time.perf_counter()
    t = s.submit(*submit_args)
    res = t.result(timeout=600)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3, t


def rows_of(what: str, out, counts, build, probe, expected: int, ref) -> None:
    check_rows(out, counts, build, probe, expected)
    if ref is not None:
        check_same_rows(sorted_rows(out, counts), ref, what)


@contextlib.contextmanager
def released(phase: str):
    """The block must give back every device byte it allocates: no
    scheduler, ticket or error of it may keep memory once its objects are
    gone (6b's four processes share the card with what this one holds).
    Reference cycles are collected first: the check is for references."""
    gc.collect()
    base = allocated()
    before = {id(o) for o in gc.get_objects() if isinstance(o, torch.Tensor)}
    yield
    gc.collect()
    torch.cuda.empty_cache()
    left_over = allocated() - base
    log("released", smoke_phase=phase, allocated_left_over=left_over,
        reserved_after=torch.cuda.memory_reserved())
    if left_over > 64 * 2**20:
        print_holders(before)
        raise AssertionError(f"{phase}: {left_over} device bytes still allocated after it")


def print_holders(before: set, top: int = 6, depth: int = 10) -> None:
    """The tensors alive now that were not alive in ``before`` (ids):
    their count and bytes, and for the largest a chain of what holds
    each: the diagnosis of a phase that leaves device memory allocated."""
    import types

    new = [o for o in gc.get_objects() if isinstance(o, torch.Tensor) and id(o) not in before]
    new.sort(key=lambda t: -t.untyped_storage().nbytes())
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in new
                if t.is_cuda}
    print(f"[holder] {len(new)} new tensors, {len(storages)} CUDA storages of "
          f"{sum(storages.values())} bytes", flush=True)
    skip = {id(new), id(storages)}
    for i in range(min(top, len(new))):
        o, seen = new[i], set()
        print(f"[holder] tensor {tuple(o.shape)} {o.dtype} {o.device} "
              f"{o.untyped_storage().nbytes()} bytes", flush=True)
        for level in range(depth):
            refs = [r for r in gc.get_referrers(o) if id(r) not in skip and id(r) not in seen
                    and not (isinstance(r, types.FrameType) and r.f_code.co_name == "print_holders")]
            skip.add(id(refs))
            if not refs:
                break
            r = refs[0]
            seen.add(id(r))
            if isinstance(r, types.FrameType):
                what = f"frame {r.f_code.co_name} {r.f_code.co_filename}:{r.f_lineno}"
            elif isinstance(r, dict) and "__builtins__" in r:
                what = f"globals of {r.get('__name__')}"
            elif isinstance(r, dict):
                what = f"dict keys {list(r)[:8]}"
            elif isinstance(r, (list, tuple)):
                what = f"{type(r).__name__} of {len(r)}: {[type(x).__name__ for x in r[:4]]}"
            else:
                what = f"{type(r).__module__}.{type(r).__qualname__}"
            print(f"[holder]   {'  ' * level}<- {what}"[:300], flush=True)
            o = r
    del new


def run_serve(dj, dev, topo, left, lcnt, right, rcnt, build, probe, expected: int, ref,
              rows: int, seed: int, smi: str) -> tuple:
    """Phase 15: the query scheduler on the card, on phase 4's and phase
    5's tables (module docstring). Returns ({path: {odf: launches}} of
    one rank, the same of the 4-rank world)."""
    from dj_tpu_torch import cache as djcache
    from dj_tpu_torch import fleet, serve
    from dj_tpu_torch.obs import metrics, truth
    from dj_tpu_torch.ops.join import prepared_effective_plan
    from dj_tpu_torch.parallel import dist_join as dist
    from dj_tpu_torch.resilience import errors, faults
    from dj_tpu_torch.serve import QueryScheduler, ServeConfig

    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    one_rank: dict = {}
    world: dict = {}
    card_bytes = torch.cuda.get_device_properties(dev).total_memory if on_card else CARD_BYTES

    cfgs = {odf: dj.JoinConfig(over_decom_factor=odf) for odf in (1, 4)}
    fcs = {odf: serve.forecast(topo, left, right, [0], [0], cfgs[odf]) for odf in (1, 4)}
    # The budget counts modeled bytes, and dj_tpu's 16e9 default refuses
    # a full-width query: set it from the forecasts.
    budget = 2.0 * max(fc.bytes for fc in fcs.values())
    serve.reset()

    # (a) a served join against the direct call, on the worker thread.
    with env_set(DJT_SERVE_HBM_BUDGET=repr(budget)), obs_on() as obs:
        sc = ServeConfig.from_env()
        if sc.hbm_budget_bytes != budget:
            raise AssertionError(f"15a: ServeConfig.from_env() read {sc.hbm_budget_bytes}")
        lines = {}
        with QueryScheduler(sc, worker=True) as s:
            for odf in (1, 4):
                what = f"15a odf={odf}"
                args = (topo, left, lcnt, right, rcnt, [0], [0], cfgs[odf])
                walls = {"direct": [], "served": []}
                for _ in range(2):  # the first warms up
                    reset_launches()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    out, counts, info, _ = dj.distributed_inner_join_auto(*args)
                    torch.cuda.synchronize()
                    walls["direct"].append((time.perf_counter() - t0) * 1e3)
                    direct_launches, direct_peak = read_launches(), torch.cuda.max_memory_allocated()
                    del out, counts, info
                    reset_launches()
                    torch.cuda.reset_peak_memory_stats()
                    (out, counts, info, used), wall, _ = served(s, args)
                    walls["served"].append(wall)
                    launches, peak = read_launches(), torch.cuda.max_memory_allocated()
                    flags_false(what, info)
                    rows_of(what, out, counts, build, probe, expected, ref)
                    del out, counts, info
                    if launches != direct_launches:
                        raise AssertionError(f"{what}: served launches {launches} != the direct "
                                             f"call's {direct_launches}")
                    if min(launches["join_scans"], launches["expand_values"]) != odf:
                        raise AssertionError(f"{what}: rows 1-2 launched {launches}")
                serves = [e for e in obs.events("serve") if e["outcome"] == "result"]
                last = serves[-1]
                one_rank.setdefault("served_unprepared", {})[odf] = launches
                lines[odf] = dict(
                    forecast_bytes=fcs[odf].bytes, card_bytes=card_bytes,
                    forecast_over_card=fcs[odf].bytes / card_bytes, peak_allocated=peak,
                    direct_peak_allocated=direct_peak,
                    forecast_over_peak=fcs[odf].bytes / peak if peak else None,
                    queued_s=last["queued_s"], run_s=last["run_s"], total_s=last["total_s"],
                    served_wall_ms=walls["served"][-1], direct_wall_ms=walls["direct"][-1],
                    served_wall_ms_runs=walls["served"], direct_wall_ms_runs=walls["direct"],
                    launches=launches, direct_launches=direct_launches,
                    worker_thread=True, used_odf=used.over_decom_factor)
        ratio = metrics.histogram_raw("dj_forecast_error_ratio")
        if ratio is None or ratio[3] != 4:
            raise AssertionError(f"15c: dj_forecast_error_ratio holds {ratio}, not the 4 served "
                                 f"results")
        for odf, line in lines.items():
            log("serve", smoke_phase="15", case="(a)", ranks=1, odf=odf, rows=rows,
                budget_bytes=budget, rows_checked=expected, same_rows_as_phase_4=True,
                forecast_error_ratio_count=ratio[3],
                forecast_error_ratio_p50=metrics.histogram_quantile("dj_forecast_error_ratio",
                                                                    0.5),
                **line, card=smi)
    torch.cuda.empty_cache()

    # (b) coalescing: four queries on a quarter of the probe table each,
    # against phase 5's side (5f's member slack), on each merge tier.
    m = rows // 4
    members = [dj.shard_table(topo, slice_rows(dj, probe, q * m, (q + 1) * m)) for q in range(4)]
    pcfg = dj.JoinConfig(key_range=(0, 2 * rows), join_out_factor=0.25)
    prep = dj.prepare_join_side(topo, right, rcnt, [0], pcfg, left_capacity=m)
    member_want = []
    for q, (lq, lcq) in enumerate(members):
        out, counts, info = dj.distributed_inner_join(topo, lq, lcq, prep, None, [0], None, pcfg)
        flags_false(f"15b singleton {q}", info)
        member_want.append(member_rows(f"15b singleton {q}", dj, out, counts, build, probe, ref,
                                       q * m, (q + 1) * m))
        del out, counts, info
    if sum(g[0].shape[0] for g in member_want) != expected:
        raise AssertionError("15b: the singletons' rows do not sum to the join's")
    with obs_on() as obs:
        for tier in TIERS:
            what = f"15b tier={tier}"
            with env_set(DJT_JOIN_MERGE=tier), QueryScheduler(ServeConfig(hbm_budget_bytes=0),
                                                              worker=False) as s:
                ts = [s.submit(topo, lq, lcq, prep, None, [0], None, pcfg) for lq, lcq in members]
                reset_launches()
                t0 = time.perf_counter()
                got = [t.result(timeout=600) for t in ts]
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                launches = read_launches()
            for q, (r, t) in enumerate(zip(got, ts)):
                if not t.coalesced:
                    raise AssertionError(f"{what}: member {q} did not coalesce")
                flags_false(f"{what} member {q}", r[2])
                check_same_rows(member_rows(f"{what} member {q}", dj, r[0], r[1], build, probe,
                                            ref, q * m, (q + 1) * m), member_want[q], what)
            del got
            coal = obs.events("coalesce")
            bad = {k: launches[k] for k in prepared_effective_plan(tier) if launches[k] != 4}
            if [e["size"] for e in coal] != [4] or bad:
                raise AssertionError(f"{what}: coalesce events {coal}, launches {bad} (4 each: "
                                     f"a member)")
            obs.drain()
            one_rank.setdefault(f"served_coalesced_{tier}", {})[1] = launches
            log("serve", smoke_phase="15", case="(b)", tier=tier, members=4, member_rows=m,
                coalesce_events=1, members_equal_singletons=True, launches=launches,
                wall_ms=wall, card=smi)
        # Member 0's flag forced: it demotes to the singleton heal.
        faults.configure("prepared.join_overflow@call=1")
        try:
            with QueryScheduler(ServeConfig(hbm_budget_bytes=0), worker=False) as s:
                ts = [s.submit(topo, lq, lcq, prep, None, [0], None, pcfg) for lq, lcq in members]
                got = [t.result(timeout=600) for t in ts]
        finally:
            faults.reset()
        for q, (r, t) in enumerate(zip(got, ts)):
            check_same_rows(member_rows(f"15b demote {q}", dj, r[0], r[1], build, probe, ref,
                                        q * m, (q + 1) * m), member_want[q], "15b demote")
        if [t.coalesced for t in ts] != [False, True, True, True] or \
                obs.counter_value("dj_serve_coalesced_total") != 3 * 4 + 4:
            raise AssertionError(f"15b: demotion {[t.coalesced for t in ts]}")
        single_factor = got[0][3].join_out_factor
        del got
        log("serve", smoke_phase="15", case="(b) demote", demoted=[0],
            singleton_join_out_factor=single_factor, coalesced=[t.coalesced for t in ts],
            rows_checked=expected, card=smi)
    torch.cuda.empty_cache()

    # (c) admission: a budget one byte under the forecast, then the
    # measured gate against the allocator.
    with obs_on() as obs:
        fc = fcs[1]
        args = (topo, left, lcnt, right, rcnt, [0], [0], cfgs[1])
        reset_launches()
        with counted_calls(dist, "run_spmd") as spmd_calls, Collectives() as coll, \
                QueryScheduler(ServeConfig(hbm_budget_bytes=fc.bytes - 1), worker=False) as s:
            try:
                s.submit(*args)
            except dj.AdmissionRejected as e:
                reject = {"forecast_bytes": e.forecast_bytes, "budget_bytes": e.budget_bytes}
            else:
                raise AssertionError("15c: a budget one byte under the forecast admitted")
        launches = read_launches()
        if any(launches.values()) or spmd_calls[0] or any(coll.counts.values()):
            raise AssertionError(f"15c: the reject launched {launches}, {spmd_calls[0]} "
                                 f"dispatches, collectives {coll.counts}")
        in_use = torch.cuda.memory_allocated()
        with env_set(DJT_SERVE_MEASURED_HBM="1",
                     DJT_SERVE_MEASURED_HBM_HEADROOM=repr(budget - in_use - fc.bytes / 2)), \
                QueryScheduler(ServeConfig(hbm_budget_bytes=budget), worker=False) as s:
            try:
                s.submit(*args)
            except dj.AdmissionRejected as e:
                measured = e.measured
            else:
                raise AssertionError("15c: the measured gate admitted past its headroom")
        evt = [e for e in obs.events("admission") if e.get("source") == "measured_hbm"]
        if measured is None or measured["bytes_in_use"] != in_use or len(evt) != 1 or \
                obs.counter_value("dj_serve_rejected_total", reason="measured_hbm") != 1:
            raise AssertionError(f"15c: measured {measured}, allocator {in_use}, events {evt}")
        log("serve", smoke_phase="15", case="(c)", one_byte_under=reject, launches=0,
            dispatches=0, collectives=0, measured=measured, allocator_bytes_in_use=in_use,
            card=smi)

    # (d) deadlines: expired in the queue, then between heal attempts.
    with obs_on() as obs:
        with QueryScheduler(ServeConfig(hbm_budget_bytes=0), worker=False) as s:
            t = s.submit(topo, left, lcnt, right, rcnt, [0], [0], cfgs[1], deadline_s=0.0)
            reset_launches()
            time.sleep(0.001)
            try:
                t.result(timeout=60)
            except dj.DeadlineExceeded as e:
                queued = e.where
            else:
                raise AssertionError("15d: an expired query ran")
            if queued != "queued" or any(read_launches().values()):
                raise AssertionError(f"15d: shed {queued}, launches {read_launches()}")
            # join_out_factor 0.01 overflows on attempt 1; the deadline is
            # half of (a)'s direct wall, so it passes during attempt 1.
            deadline_s = lines[1]["direct_wall_ms"] / 2e3
            hcfg = dj.JoinConfig(join_out_factor=0.01)
            t = s.submit(topo, left, lcnt, right, rcnt, [0], [0], hcfg, deadline_s=deadline_s)
            reset_launches()
            try:
                t.result(timeout=600)
            except dj.DeadlineExceeded as e:
                healing = e.where
            else:
                raise AssertionError("15d: the healing query finished past its deadline")
            heals = len(obs.events("heal"))
            if healing != "healing" or heals < 1 or read_launches()["join_scans"] < 1:
                raise AssertionError(f"15d: shed {healing}, {heals} heals")
        log("serve", smoke_phase="15", case="(d)", queued_shed="queued", queued_launches=0,
            healing_shed=healing, deadline_s=deadline_s, heals=heals,
            attempt_launches=read_launches(), card=smi)
    torch.cuda.empty_cache()

    # (e) the pressure ladder, walked by queries priced past the budget.
    big = dj.JoinConfig(join_out_factor=1e6)
    with env_set(DJT_JOIN_MERGE="merge"), obs_on() as obs, \
            QueryScheduler(ServeConfig(hbm_budget_bytes=budget, pressure_window=4),
                           worker=False) as s:

        def push(level):
            while s.pressure_level < level:
                try:
                    s.submit(topo, left, lcnt, right, rcnt, [0], [0], big)
                except dj.AdmissionRejected:
                    continue
                raise AssertionError("15e: a query priced past the budget was admitted")
            return sorted(errors.pinned_tiers())

        pins = {1: push(1), 2: push(2)}
        lq, lcq = members[0]
        reset_launches()
        r = s.submit(topo, lq, lcq, prep, None, [0], None, pcfg).result(timeout=600)
        merge_launches = read_launches()
        check_same_rows(member_rows("15e level 2", dj, r[0], r[1], build, probe, ref, 0, m),
                        member_want[0], "15e level 2")
        del r
        pins[3] = push(3)
        reset_launches()
        r = s.submit(topo, left, lcnt, right, rcnt, [0], [0], cfgs[4]).result(timeout=600)
        halved = read_launches()
        rows_of("15e level 3", r[0], r[1], build, probe, expected, ref)
        used_odf = r[3].over_decom_factor
        del r
        events = [(e["level"], e["action"]) for e in obs.events("pressure")]
        if pins[1] != ["wire"] or pins[2] != ["merge", "wire"] or \
                merge_launches["merge_sorted_u64"] != 0 or merge_launches["join_scans"] != 1 or \
                halved["join_scans"] != 2 or halved["expand_values"] != 2 or used_odf != 2 or \
                events != [(1, "drop_compressed_wire"), (2, "drop_optional_tiers"),
                           (3, "halve_odf")]:
            raise AssertionError(f"15e: pins {pins}, merge tier {merge_launches}, level 3 "
                                 f"{halved} at odf {used_odf}, events {events}")
        one_rank.setdefault("served_pressure_merge_pinned", {})[1] = merge_launches
        one_rank.setdefault("served_pressure_halved", {})[4] = halved
        errors.reset_pins()
        s.reset_pressure()
        log("serve", smoke_phase="15", case="(e)", pins_by_level=pins, pressure_events=events,
            level2_merge_tier_launches=merge_launches, level3_odf4_launches=halved,
            level3_used_odf=used_odf, card=smi)
    check_no_pins("15e")

    # (f) the cache and the fleet through the door.
    with obs_on() as obs:
        cache = djcache.JoinIndexCache(djcache.IndexConfig())
        icfg = dj.JoinConfig(key_range=(0, 2 * rows))
        args = (topo, left, lcnt, right, rcnt, [0], [0], icfg)
        with QueryScheduler(ServeConfig(hbm_budget_bytes=0), worker=False, index=cache) as s:
            r = s.submit(*args, tenant="f").result(timeout=600)
            rows_of("15f miss", r[0], r[1], build, probe, expected, ref)
            del r
            reset_launches()
            with counted_calls(dist, "prepare_join_side") as prepares:
                r = s.submit(*args, tenant="f").result(timeout=600)
            hit_launches = read_launches()
            rows_of("15f hit", r[0], r[1], build, probe, expected, ref)
            del r
        if prepares[0] or obs.counter_value("dj_index_hit_total") != 1 or \
                hit_launches["merge_sorted_u64"] or hit_launches["join_scans"] != 1:
            raise AssertionError(f"15f: {prepares[0]} prepares, launches {hit_launches}")
        one_rank.setdefault("served_index_hit", {})[1] = hit_launches
        resident = djcache.resident_bytes()
        fc = serve.forecast(topo, left, right, [0], [0], icfg)
        # Pinned: the door's arithmetic counts the resident side.
        lease = cache.get_or_prepare(topo, right, rcnt, [0], icfg, tenant="f",
                                     left_capacity=left.capacity)
        with QueryScheduler(ServeConfig(hbm_budget_bytes=fc.bytes + resident / 2),
                            worker=False) as s:
            try:
                s.submit(*args)
            except dj.AdmissionRejected as e:
                pinned_reserved = e.reserved_bytes
            else:
                raise AssertionError("15f: a pinned side's bytes were not counted")
        lease.release()
        del lease
        # Unpinned: only shed_bytes can make room, and the query admits.
        with QueryScheduler(ServeConfig(hbm_budget_bytes=fc.bytes + resident / 2),
                            worker=False) as s:
            r = s.submit(*args).result(timeout=600)
            rows_of("15f shed", r[0], r[1], build, probe, expected, ref)
            del r
        evicts = [e.get("reason") for e in obs.events("index") if e["op"] == "evict"]
        if pinned_reserved != resident or evicts != ["serve_pressure"] or \
                djcache.resident_bytes() != 0:
            raise AssertionError(f"15f: reserved {pinned_reserved} of {resident}, evicts "
                                 f"{evicts}")
        log("serve", smoke_phase="15", case="(f)", index_hit_prepares=0,
            hit_launches=hit_launches, resident_bytes=resident, forecast_bytes=fc.bytes,
            reject_reserved_bytes=pinned_reserved, shed_to_admit=evicts, card=smi)
        cache.clear()
        del cache
    torch.cuda.empty_cache()

    # (g) 4d's world in one process: a served query on the worker, then a
    # drain that rejects new work and finishes the queue.
    topo4 = dj.make_topology([dev] * WORLD)
    left4, lcnt4 = dj.shard_table(topo4, probe)
    right4, rcnt4 = dj.shard_table(topo4, build)
    args4 = (topo4, left4, lcnt4, right4, rcnt4, [0], [0], cfgs[1])

    def world_rows(what, r):
        flags_false(what, r[2])
        check_colocated(what, r[0], r[1], 1)
        flat = dj.unshard_table(r[0], r[1])
        flat_counts = torch.tensor([flat.capacity])
        rows_of(what, flat, flat_counts, build, probe, expected, ref)

    with obs_on() as obs:
        with QueryScheduler(ServeConfig(hbm_budget_bytes=0), worker=True) as s:
            reset_launches()
            with Collectives() as coll:
                r, wall, _ = served(s, args4)
            launches = read_launches()
            world_rows("15g", r)
            del r
        if launches["join_scans"] != WORLD or not coll.counts["all_to_all_start"]:
            raise AssertionError(f"15g: launches {launches}, collectives {coll.counts}")
        world["served_world"] = {1: launches}
        with QueryScheduler(ServeConfig(hbm_budget_bytes=0), worker=False) as s:
            t = s.submit(*args4)
            flipped = fleet.drain.begin(reason="chip_smoke")
            try:
                s.submit(*args4)
            except dj.resilience.Draining:
                pass
            else:
                raise AssertionError("15g: a draining scheduler admitted")
            world_rows("15g drained", t.result(timeout=600))
            if s not in flipped or not s.drained() or not fleet.drain.wait_quiesced(1.0):
                raise AssertionError("15g: the drain did not flip or finish")
        phases = [e["phase"] for e in obs.events("drain")]
        fleet.reset()
        log("serve", smoke_phase="15", case="(g)", ranks=WORLD, odf=1, served_wall_ms=wall,
            launches=launches, collectives=coll.counts, rows_checked=expected, colocated=True,
            drain_phases=phases, card=smi)
    del left4, right4
    torch.cuda.empty_cache()

    # (h) a short seeded soak under faults: every query ends once. The
    # members probe a quarter of the build table (unprepared, and its own
    # prepared side): at full width the results that the worker finishes
    # ahead of the checks, and the failed queries' tracebacks, outgrow
    # the card beside this phase's tables.
    sright, srcnt = dj.shard_table(topo, slice_rows(dj, build, 0, m))
    scfg = dj.JoinConfig(key_range=(0, 2 * rows))
    sprep = dj.prepare_join_side(topo, sright, srcnt, [0], scfg, left_capacity=m)
    soak_want = []
    for q, (lq, lcq) in enumerate(members):
        out, counts, info = dj.distributed_inner_join(topo, lq, lcq, sright, srcnt, [0], [0],
                                                      cfgs[1])
        flags_false(f"15h reference {q}", info)
        soak_want.append(int(counts.sum()))
        del out, counts, info
    rng = torch.Generator().manual_seed(seed + 15)
    spec = "module_build@call=3,join.join_overflow@call=5,prepared.join_overflow@call=4," \
           "pallas_merge@call=2"
    outcomes: dict = {}
    torch.cuda.reset_peak_memory_stats()
    soak_base = torch.cuda.memory_allocated()
    with env_set(DJT_JOIN_MERGE="merge"), obs_on() as obs:
        faults.configure(spec)
        pending, rejected, done, causes = collections.deque(), [], [], []
        try:
            # Room for every query queued at once (each reserves its
            # forecast until its terminal); the big ones still do not fit.
            # Groups of at most (b)'s 4: eight members against the whole
            # resident side hold more than the card beside this phase's
            # tables.
            with QueryScheduler(ServeConfig(hbm_budget_bytes=64 * budget, max_attempts=3,
                                            coalesce_max=4), worker=True) as s:
                for i in range(40):
                    kind = int(torch.randint(0, 5, (1,), generator=rng))
                    q = i % 4
                    lq, lcq = members[q]
                    try:
                        if kind == 0:
                            t = s.submit(topo, lq, lcq, sright, srcnt, [0], [0], cfgs[1])
                        elif kind == 1:
                            t = s.submit(topo, lq, lcq, sright, srcnt, [0], [0], cfgs[4])
                        elif kind == 2:
                            t = s.submit(topo, lq, lcq, sprep, None, [0], None, scfg)
                        elif kind == 3:
                            t = s.submit(topo, lq, lcq, sprep, None, [0], None, scfg,
                                         deadline_s=0.0)
                        else:
                            t = s.submit(topo, lq, lcq, sright, srcnt, [0], [0], big)
                    except dj.DJError as e:
                        rejected.append((type(e).__name__, e.query_id))
                        continue
                    pending.append((kind, q, t))
                while pending:
                    kind, q, t = pending.popleft()
                    try:
                        r = t.result(timeout=600)
                        n = int(r[1].sum())
                        del r
                        if n != soak_want[q]:
                            raise AssertionError(f"15h: a result of kind {kind} holds {n} "
                                                 f"rows, not {soak_want[q]}")
                    except dj.DJError as e:
                        if isinstance(e, dj.BackendError):
                            causes.append(f"{type(e.__cause__).__name__}: {e}"[:300])
                    outcomes[t.outcome] = outcomes.get(t.outcome, 0) + 1
                    # Not the error itself: raised in this frame, its
                    # traceback holds the frame, a cycle of its locals.
                    done.append((t.query_id, t.done,
                                 t.error is None or isinstance(t.error, dj.DJError)))
                    del t  # the ticket holds its result
        finally:
            faults.reset()
        for name, _ in rejected:
            outcomes[name] = outcomes.get(name, 0) + 1
        qids = [qid for qid, _, _ in done] + [qid for _, qid in rejected]
        open_spans = [qid for qid in qids if not obs.query_trace(qid)["complete"]]
        bad = [qid for qid, is_done, typed in done if not is_done or not typed]
        serves = obs.events("serve")
        pinned = sorted(errors.pinned_tiers())
        # A BackendError is an unexpected failure wrapped on the serve
        # path: none may arise here.
        if bad or open_spans or causes or len(serves) != len(done) or \
                sum(outcomes.values()) != 40 or outcomes.get("result", 0) < 10:
            raise AssertionError(f"15h: outcomes {outcomes}, bad {bad}, open {open_spans}, "
                                 f"{len(serves)} serve events for {len(done)} tickets, "
                                 f"BackendError causes {causes}")
        errors.reset_pins()
        log("serve", smoke_phase="15", case="(h)", queries=40, faults=spec,
            outcomes=outcomes, serve_events=len(serves), door_rejects=len(rejected),
            open_query_spans=0, pins_during=pinned, allocated_before=soak_base,
            peak_allocated=torch.cuda.max_memory_allocated(), card=smi)
    check_no_pins("15h")
    del prep, sprep, sright, members, member_want
    serve.reset()
    torch.cuda.empty_cache()
    log("serve_phase", smoke_phase="15", seconds=time.perf_counter() - t_phase, card=smi)
    return one_rank, world


# --- the observatory on the card (phase 16) ----------------------------------


# Every route of the endpoint, as a scraper asks for it: /tracez without q
# and /profilez without DJT_OBS_PROFILE_DIR answer 400, the rest 200.
OBS_ROUTES = ("/", "/metrics", "/healthz", "/queryz", "/varz", "/skewz", "/rooflinez",
              "/tenantz", "/trendz", "/knobz", "/tunez", "/tracez", "/fleetz", "/profilez")
OBS_BAD_REQUEST = ("/tracez", "/profilez")
OBS_THREADS = ("dj-obs-http", "dj-obs-history", "dj-obs-profile")
# The __global__ symbols a /profilez capture of the sort, merge and probe
# tiers' queries must hold, with the source of each (RadixSort: CUB's sort).
PROFILED_KERNELS = {"join_scans_kernel": "csrc/join_scans.cu",
                    "expand_values_kernel": "csrc/expand_values.cu",
                    "merge_splits_kernel": "csrc/merge_sorted_u64.cu",
                    "merge_kernel": "csrc/merge_sorted_u64.cu",
                    "ranks_partition": "csrc/expand_ranks.cu",
                    "ranks_merge": "csrc/expand_ranks.cu",
                    "RadixSort": "torch.sort (CUB)"}


def scrape(base: str, route: str) -> tuple:
    """GET ``base + route``: (status, content type, body, ms)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(base + route, timeout=120) as r:
            code, ctype, body = r.status, r.headers.get("Content-Type", ""), r.read().decode()
    except urllib.error.HTTPError as e:
        code, ctype, body = e.code, e.headers.get("Content-Type", ""), e.read().decode()
    return code, ctype, body, (time.perf_counter() - t0) * 1e3


class Scraper:
    """A thread that GETs every route of OBS_ROUTES in turn, round after
    round, until the block ends (the last round is finished):
    ``by_route`` = {route: [(status, ms), ...]}."""

    def __init__(self, base: str):
        self.base, self.by_route, self.error = base, {}, None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="smoke-scraper", daemon=True)

    def _loop(self):
        try:
            while not self._stop.is_set():
                for route in OBS_ROUTES:
                    code, _, _, ms = scrape(self.base, route)
                    self.by_route.setdefault(route, []).append((code, ms))
        except Exception as e:  # noqa: BLE001 - re-raised by the block's owner
            self.error = e

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=300)
        if self._thread.is_alive():
            raise AssertionError("16: the scraper did not finish its round")
        if self.error is not None:
            raise AssertionError(f"16: a scrape failed: {self.error!r}")


def parse_prometheus(text: str) -> dict:
    """{series: value} of a Prometheus text exposition; a line that is
    neither blank, a comment nor ``name{labels} value`` fails."""
    import re

    pat = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$")
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = pat.match(line)
        if m is None:
            raise AssertionError(f"16a: /metrics is not Prometheus text: {line!r}")
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def obs_threads() -> list:
    return sorted(t.name for t in threading.enumerate() if t.name in OBS_THREADS)


def kernel_names(trace: dict) -> set:
    """The names of the CUDA kernels in a Chrome trace, as the profiler
    demangles them (``(anonymous namespace)::k(args)``, ``void ns::k<...>(args)``)."""
    return {str(e.get("name", "")) for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel"}


def has_kernel(names: set, symbol: str) -> bool:
    """Whether a kernel whose symbol is ``symbol`` is among ``names``
    (``RadixSort``: any CUB radix-sort kernel)."""
    import re

    if symbol == "RadixSort":
        return any("RadixSort" in n for n in names)
    pat = re.compile(rf"(^|[\s:]){re.escape(symbol)}[(<]")
    return any(pat.search(n) for n in names)


def run_observatory(dj, dev, topo, left, lcnt, right, rcnt, build, probe, expected: int, ref,
                    rows: int, smi: str) -> tuple:
    """Phase 16: the endpoint, /profilez, the history's burn-rate alerts,
    the anomaly window and the black box on the card (module docstring).
    Returns ({path: {odf: launches}} of one rank, the same of 4d's world)."""
    import shutil

    from dj_tpu_torch import fleet
    from dj_tpu_torch.obs import history
    from dj_tpu_torch.obs import http as obs_http
    from dj_tpu_torch.serve import QueryScheduler, ServeConfig

    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    one_rank: dict = {}
    world: dict = {}
    cfg = dj.JoinConfig()
    args = (topo, left, lcnt, right, rcnt, [0], [0], cfg)
    if obs_threads():
        raise AssertionError(f"16: obs threads alive before the phase: {obs_threads()}")

    # (a) the endpoint's cost: phase 4's join served with the endpoint off,
    # then up (through init_distributed's hook) and scraped in a loop.
    def serve3(s, what):
        res, _, _ = served(s, args)  # warm
        flags_false(what, res[2])
        rows_of(what, res[0], res[1], build, probe, expected, ref)
        del res
        reset_launches()
        walls = [served(s, args)[1] for _ in range(3)]
        launches = read_launches()
        syncs = sync_calls(lambda: served(s, args))
        return walls, launches, syncs

    t_case = time.perf_counter()
    with obs_on() as obs, QueryScheduler(ServeConfig(hbm_budget_bytes=0), worker=False) as s:
        off_walls, off_launches, off_syncs = serve3(s, "16a endpoint off")
        with env_set(DJT_OBS_HTTP="0", DJT_OBS_HISTORY_S="0.25"):
            dj.init_distributed()
        addr = obs_http.server_address()
        if addr is None or not {"dj-obs-http", "dj-obs-history"} <= set(obs_threads()):
            raise AssertionError(f"16a: init_distributed started {addr}, {obs_threads()}")
        base = f"http://{addr[0]}:{addr[1]}"
        try:
            idle_walls = serve3(s, "16a endpoint idle")[0]  # up, its sampler alone
            with Scraper(base) as scraper:
                on_walls, on_launches, on_syncs = serve3(s, "16a endpoint on")
            code, ctype, text, _ = scrape(base, "/metrics")
            series = parse_prometheus(text)
            buckets = [k for k in series if k.startswith("dj_serve_latency_seconds_bucket")]
            before = allocated()
            _, _, body, _ = scrape(base, "/healthz")
            after = allocated()
            hbm = json.loads(body)["device_hbm"]
            sampled = (None if hbm is None
                       else hbm[str(torch.device(dev).index or 0)]["bytes_in_use"])
            port_gauge = obs.gauge_value("dj_obs_http_port")
            t_wait = time.monotonic()
            while history.snapshot_count() < 1 and time.monotonic() - t_wait < 30:
                time.sleep(0.05)  # the sampler's first tick
            snaps = history.snapshot_count()
        finally:
            obs_http.stop()
    codes = {r: sorted({c for c, _ in v}) for r, v in scraper.by_route.items()}
    want = {r: [400] if r in OBS_BAD_REQUEST else [200] for r in OBS_ROUTES}
    if codes != want:
        raise AssertionError(f"16a: route answers {codes}, not {want}")
    if on_launches != off_launches or on_launches["join_scans"] != 3 or \
            on_launches["expand_values"] != 3 or on_syncs != off_syncs:
        raise AssertionError(f"16a: launches {off_launches} off, {on_launches} on; synchronizing "
                             f"calls {off_syncs} off, {on_syncs} on")
    if code != 200 or not ctype.startswith("text/plain") or not buckets:
        raise AssertionError(f"16a: /metrics answered {code} {ctype} with {len(buckets)} "
                             f"dj_serve_latency_seconds buckets")
    if on_card and not before == sampled == after:
        raise AssertionError(f"16a: /healthz sampled {sampled}, memory_allocated() {before} "
                             f"before and {after} after")
    if port_gauge != addr[1] or snaps < 1:
        raise AssertionError(f"16a: dj_obs_http_port {port_gauge} for {addr}, {snaps} snapshots")
    one_rank["observatory_served"] = {1: on_launches}
    log("observatory", smoke_phase="16", case="(a)", seconds=time.perf_counter() - t_case,
        rows=rows, odf=1,
        off_wall_ms=statistics.median(off_walls), on_wall_ms=statistics.median(on_walls),
        on_over_off=statistics.median(on_walls) / statistics.median(off_walls),
        idle_wall_ms=statistics.median(idle_walls),
        idle_over_off=statistics.median(idle_walls) / statistics.median(off_walls),
        off_wall_ms_runs=off_walls, on_wall_ms_runs=on_walls, idle_wall_ms_runs=idle_walls,
        launches=on_launches,
        launches_equal=True, sync_calls=on_syncs, sync_calls_equal=True,
        scrapes={r: {"n": len(v), "median_ms": statistics.median(ms for _, ms in v),
                     "status": codes[r]} for r, v in scraper.by_route.items()},
        latency_buckets=len(buckets), healthz_device_hbm=sampled,
        memory_allocated=before, history_snapshots=snaps, card=smi)
    torch.cuda.empty_cache()

    # (b) /profilez on a live server: a capture while the worker thread
    # serves phase 5's side on each merge tier.
    t_case = time.perf_counter()
    pcfg = dj.JoinConfig(key_range=(0, 2 * rows))
    prep = dj.prepare_join_side(topo, right, rcnt, [0], pcfg, left_capacity=rows)
    pargs = (topo, left, lcnt, prep, None, [0], None, pcfg)
    pdir = tempfile.mkdtemp(prefix="smoke-profilez-")
    try:
        with obs_on() as obs, env_set(DJT_OBS_PROFILE_DIR=pdir), \
                QueryScheduler(ServeConfig(hbm_budget_bytes=0), worker=True) as s:
            host, port = obs_http.start(0)
            base = f"http://{host}:{port}"
            try:
                with env_set(DJT_JOIN_MERGE="sort"):
                    for _ in range(2):  # the first warms up
                        res, outside_ms, _ = served(s, pargs)
                        flags_false("16b outside", res[2])
                        rows_of("16b outside", res[0], res[1], build, probe, expected, ref)
                        del res
                code, _, body, _ = scrape(base, "/profilez?secs=2")
                started = json.loads(body)
                busy, _, busy_body, _ = scrape(base, "/profilez?secs=2")
                inside, walls = {}, {}
                reset_launches()
                for tier in TIERS:
                    with env_set(DJT_JOIN_MERGE=tier):
                        res, walls[tier], _ = served(s, pargs)
                        flags_false(f"16b tier={tier}", res[2])
                        rows_of(f"16b tier={tier}", res[0], res[1], build, probe, expected, ref)
                        del res
                launches = read_launches()
                t_wait = time.monotonic()
                while not [e for e in obs.events("profile") if e["state"] != "started"]:
                    if time.monotonic() - t_wait > 300:
                        raise AssertionError("16b: the capture never ended")
                    time.sleep(0.05)
                for th in threading.enumerate():
                    if th.name == "dj-obs-profile":
                        th.join(timeout=60)
            finally:
                obs_http.stop()
            ends = [e["state"] for e in obs.events("profile")]
            captures = obs.counter_value("dj_profile_captures_total")
        if code != 200 or not started.get("ok") or busy != 409 or \
                not json.loads(busy_body).get("busy") or ends != ["started", "stopped"] or \
                captures != 1:
            raise AssertionError(f"16b: /profilez answered {code} {started}, then {busy} "
                                 f"{busy_body}; events {ends}, captures {captures}")
        with open(started["path"]) as f:
            trace_bytes = f.seek(0, 2)
            f.seek(0)
            prof = json.load(f)
        names = kernel_names(prof)
        found = {k: has_kernel(names, k) for k in PROFILED_KERNELS}
        if on_card and not all(found.values()):
            raise AssertionError(f"16b: the capture lacks {[k for k, v in found.items() if not v]}"
                                 f" among its {len(names)} kernel names: {sorted(names)[:40]}")
        if not prof.get("traceEvents"):
            raise AssertionError("16b: the capture holds no event")
        want = {"join_scans": 2, "expand_values": 2, "merge_sorted_u64": 1, "expand_ranks": 1}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"16b: the tiers launched {launches}, not {want}")
    finally:
        shutil.rmtree(pdir, ignore_errors=True)
    one_rank["observatory_profiled"] = {1: launches}
    log("observatory", smoke_phase="16", case="(b)", seconds=time.perf_counter() - t_case,
        rows=rows, odf=1, capture_s=2,
        busy_status=busy, kernels_found=found, kernel_names=len(names),
        trace_events=len(prof["traceEvents"]), trace_bytes=trace_bytes,
        query_inside_capture_ms=walls, query_outside_capture_ms=outside_ms, launches=launches,
        card=smi)
    del prep, prof
    torch.cuda.empty_cache()

    # (c) the history and the burn-rate alerts over served queries and
    # queued deadline sheds, on a timeline of sample_now(now=) ticks.
    t_case = time.perf_counter()
    with obs_on() as obs, env_set(DJT_SLO_BURN_FAST_S="60", DJT_SLO_BURN_SLOW_S="600",
                                  DJT_SLO_BURN_RATE="0.3", DJT_OBS_HISTORY_S="3600"), \
            QueryScheduler(ServeConfig(hbm_budget_bytes=0), worker=False) as s:
        history.reset()
        host, port = obs_http.start(0)  # its sampler waits an hour: the ticks are ours
        try:
            t0 = 1_000_000.0
            for k in range(11):  # healthy ticks spanning the slow window
                res, _, _ = served(s, args)
                del res
                history.sample_now(now=t0 + 60 * k)
            if obs.events("slo_alert"):
                raise AssertionError(f"16c: healthy ticks fired {obs.events('slo_alert')}")
            sheds = 0
            for k in range(1, 12):  # the storm: two queued deadline sheds a tick
                for _ in range(2):
                    t = s.submit(*args, deadline_s=0.0)
                    time.sleep(0.001)
                    try:
                        t.result(timeout=60)
                    except dj.DeadlineExceeded:
                        sheds += 1
                    else:
                        raise AssertionError("16c: an expired query ran")
                    del t
                history.sample_now(now=t0 + 600 + 60 * k)
                firing = [(e["slo"], e["window"]) for e in obs.events("slo_alert")
                          if e["state"] == "firing"]
                if ("deadline_miss", "slow") in firing:
                    break
            _, _, body, _ = scrape(f"http://{host}:{port}", "/trendz?n=64")
            trend = json.loads(body)
        finally:
            obs_http.stop()
        alerts = [(e["slo"], e["window"], e["state"]) for e in obs.events("slo_alert")]
        totals = {w: obs.counter_value("dj_slo_alert_total", slo="deadline_miss", window=w)
                  for w in ("fast", "slow")}
    last = trend["snapshots"][-1] if trend["snapshots"] else {}
    if alerts != [("deadline_miss", "fast", "firing"), ("deadline_miss", "slow", "firing")] or \
            totals != {"fast": 1, "slow": 1} or len(trend["snapshots"]) < 8 or \
            trend["alerts"].get("deadline_miss:fast") is not True or \
            (on_card and not last.get("device_hbm")) or last.get("deadline_shed") != sheds:
        raise AssertionError(f"16c: alerts {alerts}, totals {totals}, /trendz "
                             f"{len(trend['snapshots'])} snapshots, alerts {trend['alerts']}, "
                             f"last {last}")
    log("observatory", smoke_phase="16", case="(c)", seconds=time.perf_counter() - t_case,
        served=11, deadline_sheds=sheds,
        alerts=alerts, alert_totals=totals, trendz_snapshots=len(trend["snapshots"]),
        trendz_alerts=trend["alerts"], last_device_hbm=last.get("device_hbm"), card=smi)

    # (d) /fleetz and the anomaly window: 4d's join with the skew probe.
    t_case = time.perf_counter()
    fdir = tempfile.mkdtemp(prefix="smoke-fleet-")
    topo4 = dj.make_topology([dev] * WORLD)
    l4, l4c = dj.shard_table(topo4, probe)
    r4, r4c = dj.shard_table(topo4, build)
    try:
        with obs_on() as obs, env_set(DJT_OBS_SKEW="1", DJT_FLEET_DIR=fdir):
            host, port = obs_http.start(0)
            try:
                reset_launches()
                out, counts, info = dj.distributed_inner_join(topo4, l4, l4c, r4, r4c, [0], [0],
                                                              cfg)
                torch.cuda.synchronize()
                launches4 = read_launches()
                flags_false("16d", info)
                check_colocated("16d", out, counts, 1)
                out = dj.unshard_table(out, counts)
                counts = torch.tensor([int(counts.sum())])
                rows_of("16d", out, counts, build, probe, expected, ref)
                del out, counts, info
                obs.fleet_snapshot()
                _, _, body, _ = scrape(f"http://{host}:{port}", "/fleetz")
                fz = json.loads(body)
            finally:
                obs_http.stop()
            skews = len(obs.events("skew"))
            anomalies = obs.events("anomaly")
    finally:
        fleet.reset()
        shutil.rmtree(fdir, ignore_errors=True)
    phases = sorted({r["phase"] for r in fz["scores"]})
    coord = fz["coordination"] or {}
    if fz["window"]["stored"] < 2 or fz["window"]["capacity"] != 16 or \
            fz["thresholds"] != {"ratio": 2.0, "z": 2.0} or "wire" not in phases or \
            len(phases) < 2 or fz["anomalous"] or anomalies or skews < 1 or \
            not coord.get("enabled") or coord.get("dir") != fdir or \
            min(launches4["join_scans"], launches4["expand_values"]) != WORLD:
        raise AssertionError(f"16d: /fleetz {json.dumps(fz)[:2000]}, anomalies {anomalies}, "
                             f"{skews} skew events, launches {launches4}")
    world["observatory_fleet"] = {1: launches4}
    log("observatory", smoke_phase="16", case="(d)", seconds=time.perf_counter() - t_case,
        ranks=WORLD, odf=1,
        window=fz["window"], thresholds=fz["thresholds"], scored_phases=phases,
        scores=len(fz["scores"]), max_ratio=max(r["ratio"] for r in fz["scores"]),
        anomalous=fz["anomalous"], fleet_ranks=len(fz["fleet"]["ranks"]), skew_events=skews,
        coordination_enabled=coord.get("enabled"), launches=launches4, card=smi)
    del l4, l4c, r4, r4c, topo4
    torch.cuda.empty_cache()

    # (e) the black box under SIGTERM: the soak's hard-death arm, its
    # child serving on this card at this run's rows.
    t_case = time.perf_counter()
    bdir = tempfile.mkdtemp(prefix="smoke-blackbox-")
    try:
        p = subprocess.run(
            [sys.executable, "-m", "dj_tpu_torch.scripts.chaos_soak", "--hard-death",
             "--device", "cuda" if on_card else "cpu", "--rows", str(rows),
             "--blackbox-dir", bdir],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(bdir, ignore_errors=True)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1]) if lines else {}
    if p.returncode != 0 or not summary.get("ok") or \
            summary.get("serve_queued", 0) + summary.get("serve_reserved_bytes", 0) <= 0:
        raise AssertionError(f"16e: the hard-death arm exited {p.returncode}: {summary}; "
                             f"stderr {p.stderr[-2000:]}")
    log("observatory", smoke_phase="16", case="(e)", seconds=time.perf_counter() - t_case,
        rows=rows, device=summary["device"],
        child_exit=summary["child_exit"],
        child_imported_s=summary["child_imported_s"],
        child_to_kill_s=summary["child_to_kill_s"], child_wall_s=summary["elapsed_s"],
        bundle_bytes=summary["bundle_bytes"],
        bundle_sections=summary["bundle_sections"], open_timelines=summary["open_timelines"],
        serve_queued=summary["serve_queued"], serve_reserved_bytes=summary["serve_reserved_bytes"],
        card=smi)

    history.reset()
    if obs_threads():
        raise AssertionError(f"16: obs threads alive after the phase: {obs_threads()}")
    log("observatory_phase", smoke_phase="16", seconds=time.perf_counter() - t_phase, card=smi)
    return one_rank, world


# --- phase 17: the soak on the card ------------------------------------------

SOAK_ROWS = 1_000_000  # the walk's and the drill's rows (PERF.md §4: the cut and why)
SOAK_WORLD = 4
# The drill's world: at 4 ranks the one-key build side of its phase 3
# fits bucket_factor 4 (rows / 4 a destination), its prepare heals
# nothing and the replay check is vacuous; dj_tpu's drill runs 8.
DRILL_WORLD = 8
NATIVE_ROWS = 10_000_000
PATH_KERNELS = ("join_scans", "expand_values", "expand_ranks", "merge_sorted_u64")


def child_pids() -> list:
    """The live child processes of this one (from /proc)."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.append(int(d))
    return out


def run_soak(dj, dev, build, rows: int, seed: int, smi: str) -> dict:
    """Phase 17: the soak's walk and fleet drill on the card, then the
    native host runtime (module docstring). Returns each part's kernel
    launches, counted from 0 just before it."""
    import numpy as np

    from dj_tpu_torch import native
    from dj_tpu_torch.parallel.dist_join import MAIN_JOIN_SEED
    from dj_tpu_torch.scripts import chaos_soak

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    n = min(SOAK_ROWS, rows)
    device = torch.device(dev).type  # "cuda"; "cpu" in a CPU rehearsal
    launches: dict = {}
    if child_pids() or obs_threads():
        raise AssertionError(f"17: children {child_pids()} or obs threads {obs_threads()} "
                             f"alive before the phase")

    # (a) the walk: every spec of FAULT_WALK under the scheduler, in a
    # 4-rank world on this card.
    with obs_on():
        reset_launches()
        walk = chaos_soak.main_walk(device, n, SOAK_WORLD)
        launches["walk"] = read_launches()
    print(json.dumps(walk), flush=True)
    if not walk["ok"]:
        raise AssertionError(f"17(a): the walk broke {len(walk['violations'])} invariant(s): "
                             f"{walk['violations'][:10]}")
    if walk["traces_complete"] != f"{walk['queries']}/{walk['queries']}" or \
            walk["sites"] != len(chaos_soak.FAULT_WALK):
        raise AssertionError(f"17(a): not every ticket ended once: {walk['traces_complete']} "
                             f"of {walk['queries']}, {walk['sites']} sites")
    missing = [k for k in PATH_KERNELS if not launches["walk"][k]]
    if missing:
        raise AssertionError(f"17(a): the walk launched no {missing}: {launches['walk']}")
    log("soak", smoke_phase="17", case="(a) walk", rows=n, ranks=SOAK_WORLD,
        seconds=walk["elapsed_s"], queries=walk["queries"], outcomes=walk["outcomes"],
        traces_complete=walk["traces_complete"], truth=walk["truth"],
        audits=walk["collective_audits"]["verdicts"], launches=launches["walk"], card=smi)
    check_no_pins("17(a)")

    # (b) the fleet drill: three peers in processes of their own, each
    # with its own CUDA context on this card.
    with obs_on():
        reset_launches()
        drill = chaos_soak.fleet_drill(device, n, DRILL_WORLD)
        launches["drill"] = read_launches()
    print(json.dumps(drill), flush=True)
    if not drill["ok"]:
        raise AssertionError(f"17(b): the drill broke {drill['violations']}")
    log("soak", smoke_phase="17", case="(b) drill", rows=n, ranks=DRILL_WORLD,
        seconds=drill["elapsed_s"], phases=drill["phases"], launches=launches["drill"], card=smi)
    check_no_pins("17(b)")

    # (c) the native runtime, built from this checkout's source.
    t_case = time.perf_counter()
    if not native.build(force=True) or not native.is_available():
        raise AssertionError("17(c): the native runtime did not build (no g++)")
    build_s = time.perf_counter() - t_case
    keys = build.columns[0].data
    hashes = {}
    for hseed in (dj.DEFAULT_HASH_SEED, MAIN_JOIN_SEED):  # 0, and the partition's 12345678
        host = native.murmur3_32(keys.cpu().numpy(), hseed)
        card = dj.murmur3_32(keys, hseed).cpu().numpy()
        if not np.array_equal(host.astype(np.int64), card):
            bad = int(np.flatnonzero(host.astype(np.int64) != card)[0])
            raise AssertionError(f"17(c): murmur3 seed {hseed} differs at row {bad}: host "
                                 f"{host[bad]}, card {card[bad]}")
        hashes[hseed] = int(host.size)
    del host, card
    b, p = native.generate_build_probe(NATIVE_ROWS, NATIVE_ROWS, 0.3, 2 * NATIVE_ROWS,
                                       unique_build=True, seed=seed)
    want = native.expected_match_count(NATIVE_ROWS, 0.3, seed=seed)
    topo1 = dj.make_topology([dev])
    ids = np.arange(NATIVE_ROWS, dtype=np.int64)
    right, rcnt = dj.shard_table(topo1, dj.from_arrays(b, ids, device=dev))
    left, lcnt = dj.shard_table(topo1, dj.from_arrays(p, ids, device=dev))
    del b, p, ids
    reset_launches()
    out, counts, info = dj.distributed_inner_join(topo1, left, lcnt, right, rcnt, [0], [0],
                                                  dj.JoinConfig())
    launches["native_join"] = read_launches()
    flags_false("17(c)", info)
    total = int(counts.sum())
    if total != want:
        raise AssertionError(f"17(c): the native-generated join gave {total} rows, "
                             f"expected_match_count {want}")
    del out, counts, info, left, right
    log("soak", smoke_phase="17", case="(c) native", build_s=build_s, murmur3_rows=hashes,
        native_rows=NATIVE_ROWS, matches=total, expected_match_count=want,
        launches=launches["native_join"], seconds=time.perf_counter() - t_case, card=smi)

    torch.cuda.synchronize(dev)
    if child_pids() or obs_threads():
        raise AssertionError(f"17: children {child_pids()} or obs threads {obs_threads()} "
                             f"alive after the phase")
    log("soak_phase", smoke_phase="17", seconds=time.perf_counter() - t_phase,
        peak_bytes=torch.cuda.max_memory_allocated(dev), launches=launches, card=smi)
    return launches


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
        # A tier pinned by this process's degradation ladder (the parent
        # fails the run on any).
        result["pinned"] = dj.resilience.pinned_tiers()
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
    pinned = {res["rank"]: res["pinned"] for res in results if res["pinned"]}
    if pinned:
        raise AssertionError(f"the degradation ladder pinned tiers in a process: {pinned}")
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


# The string passes of a call as the program's phase record names them:
# the spans strings (offsets and char gather), string_hash and verify
# under any phase, and the exchange's bucketize and compact phases.
STRING_PASSES = ("strings", "string_hash", "verify", "a2a_bucketize", "a2a_compact")


class StringPasses:
    """Device ms of the string passes in the calls made inside the block,
    read from ``spmd.record_phases`` (summed over the calls, the ranks and
    the phases a span nests in): ``ms()`` gives {pass: ms}."""

    def __enter__(self):
        from dj_tpu_torch.parallel import spmd

        self._record = spmd.record_phases()
        self.runs = self._record.__enter__()
        return self

    def __exit__(self, *exc):
        self._record.__exit__(*exc)

    def ms(self) -> dict:
        out: dict = {}
        for ranks in self.runs:
            for phases in ranks:
                for key, ms in phases.items():
                    name = key.rsplit("/", 1)[-1]
                    if name in STRING_PASSES:
                        out[name] = out.get(name, 0.0) + ms
        return out


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
        with StringPasses() as timer:
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

    check_no_pins("4")

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

    check_no_pins("4b")

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

    check_no_pins("4c")

    # 4h. the join's plan knobs
    launch_table.update(run_knobs(dj, topo, left, lcnt, right, rcnt, build, probe, expected, ref,
                                  walls, smi))
    torch.cuda.empty_cache()

    check_no_pins("4h")

    # 4d. the main path over a 4-rank world on this card
    world_launches, world_digests = run_world(dj, dev, build, probe, expected, ref, rows, smi)
    torch.cuda.empty_cache()

    check_no_pins("4d")

    # 11. observability on phase 4's and 4d's joins
    world_launches.update(run_observability(dj, dev, topo, left, lcnt, right, rcnt, build, probe,
                                            expected, ref, rows, smi))
    torch.cuda.empty_cache()

    check_no_pins("11")

    # 4e. the same 4 ranks as 2 domains of 2; 4f. shuffle_on
    two_level_launches, two_level_digests = run_two_level(dj, dev, build, probe, expected, ref,
                                                          rows, smi)
    torch.cuda.empty_cache()
    shuffle_digests = run_shuffle_on(dj, dev, rows, args.seed, smi)
    torch.cuda.empty_cache()

    check_no_pins("4e, 4f")

    # 4g. the cascaded codec alone; 4e and 4f again, compressed
    codec = check_codec(dev, 4, min(rows // 100, 1_000_000), args.seed, smi,
                        time_rows=2 * rows // (WORLD * WORLD))
    torch.cuda.empty_cache()
    two_level_launches.update(run_two_level_compressed(dj, dev, build, probe, expected, ref,
                                                       rows, smi))
    torch.cuda.empty_cache()
    run_shuffle_on_compressed(dj, dev, rows, args.seed, smi, shuffle_digests)
    torch.cuda.empty_cache()

    check_no_pins("4g, 4e and 4f compressed")

    # 4i. the unprepared plan tiers (broadcast, salted) in 4d's world
    plan_launches, plan_digests = run_plan_tiers(dj, dev, build, probe, expected, ref, rows, smi,
                                                 two_level_digests)
    world_launches.update(plan_launches)
    torch.cuda.empty_cache()

    check_no_pins("4i")

    # The warmups; 4j. a two-stage chain with a local stage in 4d's world;
    # 4k. the coalesced unprepared dispatch with shape buckets
    run_warmups(dj, dev, smi)
    world_launches.update(run_pipeline_chain(dj, dev, build, probe, expected, ref, rows, smi))
    torch.cuda.empty_cache()
    world_launches.update(run_coalesced_bucketed(dj, dev, build, probe, rows, smi))
    torch.cuda.empty_cache()

    check_no_pins("warmups, 4j, 4k")

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

    check_no_pins("5, 5d")

    # 5d. expand_values on the probe tier's edge cases
    probe_errs = [probe_err] + probe_values_edge_cases(gen, dev, 1_000_000)
    torch.cuda.empty_cache()

    check_no_pins("5d edge cases")

    # 5c. appends to the prepared side
    append_launches, append_world = run_appends(dj, dev, gen, topo, left, lcnt, right, rcnt, build,
                                                probe, expected, rows, smi)
    launch_table.update(append_launches)
    torch.cuda.empty_cache()

    check_no_pins("5c")

    # 5e. the broadcast- and salted-prepared build sides in 4d's world
    world_launches.update(run_prepared_tiers(dj, dev, gen, topo, left, lcnt, build, probe,
                                             expected, ref, rows, smi))
    torch.cuda.empty_cache()

    check_no_pins("5e")

    # 5f. the coalesced prepared dispatch in 4d's world
    world_launches.update(run_coalesced_prepared(dj, dev, gen, build, probe, expected, ref, rows,
                                                 smi))
    torch.cuda.empty_cache()

    check_no_pins("5f")

    # 5b. unsigned keys and payloads
    check_unsigned_path(dj, topo, gen, dev, min(rows, 1_000_000))
    torch.cuda.empty_cache()

    check_no_pins("5b")

    # 7a-7c. every fixed-width key kind, float keys' special values, and
    # distributed_inner_join_auto
    launch_table.update(run_key_kinds(dj, topo, build, probe, expected, ref, smi))
    launch_table.update(check_float_specials(dj, gen, dev, min(rows, 1_000_000), smi))
    launch_table.update(check_auto(dj, dev, topo, left, lcnt, right, rcnt, build, probe, expected,
                                   ref, rows, smi))
    torch.cuda.empty_cache()

    check_no_pins("7a-7c")

    # 8a-8d. string columns on one GPU's split of TPC-H at scale factor 100
    tpch_launches, tpch_world = run_strings(dj, dev, args.seed, args.orders, smi)
    launch_table.update(tpch_launches)
    world_launches.update(tpch_world)
    world_launches.update(append_world)

    check_no_pins("8a-8d")

    # 8e. the prepared side with string columns, on phase 8's split
    orders, lineitem, customer, n_cust = tpch_tables(dj, dev, args.seed, args.orders)
    li_sorted = torch.sort(lineitem_words(*(c.data for c in lineitem.columns))).values
    tpch_launches, tpch_world = run_prepared_strings(dj, dev, orders, lineitem, li_sorted, smi)
    launch_table.update(tpch_launches)
    world_launches.update(tpch_world)
    del li_sorted
    torch.cuda.empty_cache()

    check_no_pins("8e")

    # 8g. TPC-H Q3's joins as one pipeline, on phase 8's split
    tpch_launches, tpch_world = run_q3_pipeline(dj, dev, orders, lineitem, customer, n_cust, smi)
    launch_table.update(tpch_launches)
    world_launches.update(tpch_world)
    del orders, lineitem, customer
    torch.cuda.empty_cache()

    check_no_pins("8g")

    # 12. the degradation ladder and the fault sites on the card
    run_ladder(dj, dev, topo, left, lcnt, right, rcnt, ref, rows, args.seed, smi)
    torch.cuda.empty_cache()
    check_no_pins("12 (after reset_pins)")

    # 13. the measurement and control layer: the byte model, truth, the
    # skew probe and the autotuner
    t_13 = time.perf_counter()
    run_byte_model(dj, dev, topo, left, lcnt, right, rcnt, rows, expected, smi)
    run_truth(dev, smi)
    run_skew(dj, dev, build, probe, rows, smi)
    world_launches.update(run_autotune(dj, dev, build, probe, expected, ref, rows, smi))
    torch.cuda.empty_cache()
    log("measurement_phase", smoke_phase="13", seconds=time.perf_counter() - t_13, card=smi)
    check_no_pins("13")

    # 14. the join-index cache and fleet coordination on phase 5's side
    index_launches, index_world = run_index_cache(dj, dev, topo, left, lcnt, right, rcnt, build,
                                                  probe, expected, ref, rows, prep_walls[1],
                                                  query_walls, smi)
    launch_table.update(index_launches)
    world_launches.update(index_world)
    torch.cuda.empty_cache()
    check_no_pins("14")

    # 15. admission and the query scheduler on phase 4's and 5's tables
    with released("15"):
        serve_launches, serve_world = run_serve(dj, dev, topo, left, lcnt, right, rcnt, build,
                                                probe, expected, ref, rows, args.seed, smi)
    launch_table.update(serve_launches)
    world_launches.update(serve_world)
    torch.cuda.empty_cache()
    check_no_pins("15")

    # 16. the observatory: the endpoint, /profilez, the history, the
    # anomaly window and the black box
    with released("16"):
        obs_launches, obs_world = run_observatory(dj, dev, topo, left, lcnt, right, rcnt, build,
                                                  probe, expected, ref, rows, smi)
    launch_table.update(obs_launches)
    world_launches.update(obs_world)
    torch.cuda.empty_cache()
    check_no_pins("16")

    # 17. the soak on the card: the fault walk, the fleet drill and the
    # native host runtime
    with released("17"):
        soak_launches = run_soak(dj, dev, build, rows, args.seed, smi)
    torch.cuda.empty_cache()
    check_no_pins("17")

    # 6a. a process world of one over NCCL
    process1_launches = process_world_of_one(dj, dev, "nccl", build, probe, expected, ref, rows, smi)
    del ref
    torch.cuda.empty_cache()
    first_join_with_warmup(dj, dev, "nccl", build, probe, smi)
    torch.cuda.empty_cache()
    chain_rows = min(CHAIN_ROWS, rows)
    chain_want = chain_in_one_process(dj, dev, chain_rows, args.seed)
    torch.cuda.empty_cache()

    check_no_pins("6a")

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

    check_no_pins("6b")

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

    check_no_pins("6c")

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

    check_no_pins("6 edge cases")

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

    check_no_pins("10, 10b")

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
        # Phase 17: the walk (4-rank world), the drill's parent, the
        # native-generated join (one rank), each counted from 0.
        k["launches_phase17"] = ({part: c[k["name"]] for part, c in soak_launches.items()}
                                 if on_path else {})
        k["ptxas"] = ptxas_resources(k["source"])
    log("total", seconds=round(time.perf_counter() - t_start, 1), card=smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
