"""Drive dj_tpu_torch's main path on one CUDA card and check it.

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
     key, where csum wraps) and (c) an all-miss input;
  4. main path: generate 100M build x 100M probe int64 rows (selectivity
     0.3, unique build keys), shard, distributed_inner_join at
     over_decom_factor 1 and 4; every flag False, total equal to the
     generator's expected count, every output row checked against the
     inputs, and both kernels launched by the join itself;
  5. timings: median join wall over warm runs, peak memory, a profiler
     breakdown of one warm join by kernel, and the `kernels` JSON line (kernel, plain-version and library times beside
     each kernel's bound).
The last line is {"ok": true, "device": {...}}. With no CUDA device, or
without the package beside it, the script fails before printing any
result. ``--rows N`` shrinks the main path (for a quick first check).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

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
    from dj_tpu_torch.ops.join import _packed_sorted_words

    lk, rk = probe.columns[0].data, build.columns[0].data
    L, R = lk.shape[0], rk.shape[0]
    tag_bits = max(1, (L + R).bit_length())
    lc = torch.tensor(L, dtype=torch.int32, device=device)
    rc = torch.tensor(R, dtype=torch.int32, device=device)
    sp, _ = _packed_sorted_words(lk, rk, lc, rc, tag_bits, None)
    return sp, lc, rc, tag_bits, L, R


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


def compare_kernels(case: str, sp, lc, rc, tag_bits, L, R, n_out, timing: bool,
                    need_global_windows: bool = False):
    """join_scans and expand_values against their plain versions; returns
    the two kernels' max |kernel - plain| and, with ``timing``, times."""
    from dj_tpu_torch.ops import expand, scan

    got = scan.join_scans(sp, lc, rc, tag_bits, L, R)
    want = scan.join_scans_plain(sp, lc, rc, tag_bits, L, R)
    torch.cuda.synchronize()
    scan_err = max_abs_diff(zip(got, want))
    if scan_err:
        for name, g, w in zip(("stag", "run_start", "cnt", "csum"), got, want):
            if bool((g != w).any()):
                bad = int(torch.nonzero(g != w)[0])
                raise AssertionError(f"{case}: join_scans {name} differs first at {bad}: {int(g[bad])} vs {int(w[bad])} (max |err| {scan_err})")
    del want
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
        S_mod_tile=S % 4096, join_scans_max_abs_err=scan_err,
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
    word = sp.clone()
    t["sort_ms"] = cuda_ms(lambda: torch.sort(word), 3)
    del word
    t.update(S=S, n_out=n_out)
    return scan_err, exp_err, t


def profile_join(odf: int, run) -> None:
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
    log("profile", odf=odf, wall_ms=wall_ms, device_busy_ms=busy_ms,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000_000,
                    help="build and probe rows of the main path (default 100M)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 1
    import dj_tpu_torch as dj
    from dj_tpu_torch.ops import cuda_build, expand, scan
    from dj_tpu_torch.parallel.dist_join import batch_sizing

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
    torch.cuda.empty_cache()

    # 4. main path through the user's entry points
    topo = dj.make_topology()
    left, lcnt = dj.shard_table(topo, probe)
    right, rcnt = dj.shard_table(topo, build)
    main_launches = {}
    walls = {}
    peaks = {}
    for odf in (1, 4):
        cfg = dj.JoinConfig(over_decom_factor=odf)
        scan.launches = expand.launches = 0
        out, counts, info = dj.distributed_inner_join(topo, left, lcnt, right, rcnt, [0], [0], cfg)
        torch.cuda.synchronize()
        launches = {"join_scans": scan.launches, "expand_values": expand.launches}
        set_flags = [k for k, v in info.items() if bool(v.any())]
        if set_flags:
            raise AssertionError(f"odf={odf}: flags set: {set_flags}")
        check_rows(out, counts, build, probe, expected)
        if min(launches.values()) < 1:
            raise AssertionError(f"odf={odf}: a kernel was not launched: {launches}")
        main_launches[odf] = launches
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
        profile_join(odf, lambda: dj.distributed_inner_join(
            topo, left, lcnt, right, rcnt, [0], [0], cfg))

    # 5. timings
    S, n_out = timing["S"], timing["n_out"]
    scan_bytes = 8 * S + 4 * 4 * S
    expand_bytes = 4 * 4 * S + 2 * 4 * n_out
    log("timings", join_wall_ms_odf1=walls[1], join_wall_ms_odf4=walls[4],
        peak_bytes_odf1=peaks[1], peak_bytes_odf4=peaks[4], sort_ms=timing["sort_ms"],
        sort_S=S, card=smi)
    kernels = [
        {
            "name": "join_scans", "route": "cuda", "source": "dj_tpu_torch/csrc/join_scans.cu",
            "replaces": "dj_tpu/ops/pallas_scan.py:237",
            "launches": main_launches[1]["join_scans"], "launches_odf4": main_launches[4]["join_scans"],
            "max_abs_err": max(e[0] for e in errs), "ms": timing["scan_ms"],
            "plain_ms": timing["scan_plain_ms"],
            "bound_ms": scan_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "expand_values", "route": "cuda", "source": "dj_tpu_torch/csrc/expand_values.cu",
            "replaces": "dj_tpu/ops/pallas_expand.py:841",
            "launches": main_launches[1]["expand_values"], "launches_odf4": main_launches[4]["expand_values"],
            "max_abs_err": max(e[1] for e in errs), "ms": timing["expand_ms"],
            "plain_ms": timing["expand_plain_ms"],
            "bound_ms": expand_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": timing["searchsorted_ms"],
            "library_call": "torch.searchsorted(csum, arange(n_out), right=True)",
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
