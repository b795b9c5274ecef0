"""Chaos soak of the serving stack: the scheduler and its observatory
survive every way a worker fails.

Counterpart of the JAX package's ``scripts/chaos_soak.py``. That script
has three arms, and each is a function of its own here:

- the main walk (a fixed query mix through ``QueryScheduler`` while
  deterministic faults walk every site family; every ticket ends once,
  typed, with a closed timeline);
- the fleet drill (``--fleet``: subprocess peers sharing one
  ``DJT_FLEET_DIR``: a deferred prepare, a reclaimed stale lease, a
  replayed heal);
- the hard-death arm (``--hard-death``), ported here.

The hard-death arm proves that the observatory outlives the scheduler.
A child process (this module run with ``--hard-death-child``) arms the
black box from ``DJT_OBS_BLACKBOX``, submits 4 queries to a
``QueryScheduler`` with a worker thread, and sends itself SIGTERM with
the queries in flight, as a preempted worker dies. The parent audits
what it left:

1. the child died by the signal (exit -15, or 143 through a shell);
2. no bare traceback in its output;
3. exactly one bundle, with every section whole and reason ``sigterm``
   (and the dump's own ``blackbox`` event in its ring);
4. a submitted query whose timeline is open, its ``query`` span begun
   and not ended;
5. the reader, ``dj_tpu_torch/scripts/blackbox_read.py`` (run by its
   path: it is stdlib only), exits 0 and names that query.

It prints one line ``{"metric": "chaos_soak_hard_death", "ok": ...}``
and exits 0 when all five hold. ``--device cuda`` (the default) serves
on the card at ``--rows`` build and probe rows (phase 4's generator:
selectivity 0.3, unique build keys); ``--device cpu`` serves on CPU
tensors. The admission budget is off in the child (a full-width
query's forecast exceeds the default): the arm tests the black box, not
the door.

Usage: python -m dj_tpu_torch.scripts.chaos_soak --hard-death
       [--device cuda|cpu] [--rows N] [--blackbox-dir DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT_S = 600.0
SECTIONS = ("meta", "traces", "ring", "metrics", "knobs", "serve", "ledger", "fleet",
            "coordination")


def hard_death_child(device: str, rows: int) -> int:
    """The victim (module docstring): arm the black box, put queries in
    flight and die by SIGTERM. A return is a failure of the arm."""
    t_main = time.time()  # ``-m`` has imported the package, and torch
    import signal

    import torch

    import dj_tpu_torch as dj
    from dj_tpu_torch import obs
    from dj_tpu_torch.obs import forensics
    from dj_tpu_torch.serve import QueryScheduler, ServeConfig

    if not forensics.maybe_arm_from_env():
        print("chaos_soak: the child expects DJT_OBS_BLACKBOX in its environment",
              file=sys.stderr)
        return 3
    obs.enable()
    if device == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        topo = dj.make_topology()
    else:
        dev = torch.device("cpu")
        topo = dj.make_topology(["cpu"])
    gen = torch.Generator(device=dev).manual_seed(3)
    build, probe = dj.generate_build_probe_tables(gen, rows, rows, 0.3, 2 * rows, True)
    left, lc = dj.shard_table(topo, probe)
    right, rc = dj.shard_table(topo, build)
    sched = QueryScheduler(ServeConfig(hbm_budget_bytes=0), worker=True)
    # Nobody waits for a result: the worker may finish the first query,
    # the later ones are still queued or running when the signal lands.
    tickets = [sched.submit(topo, left, lc, right, rc, [0], [0], dj.JoinConfig())
               for _ in range(4)]
    print(json.dumps({"child_qids": [t.query_id for t in tickets], "t_main": t_main,
                      "t_kill": time.time()}), flush=True)
    # The black box's handler dumps, restores the default disposition and
    # raises the signal again: the exit code must still say SIGTERM.
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(TIMEOUT_S)  # never reached
    return 3


def hard_death(device: str = "cuda", rows: int = 2048, bb_dir=None) -> int:
    """The auditor (module docstring): run the child, check what it left,
    print the summary line; 0 when every check held."""
    bb_dir = bb_dir or tempfile.mkdtemp(prefix="djt-soak-blackbox-")
    os.makedirs(bb_dir, exist_ok=True)
    env = dict(os.environ, DJT_OBS_BLACKBOX=bb_dir)  # cwd=REPO makes ``-m`` find the package
    t0, t_start = time.perf_counter(), time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "dj_tpu_torch.scripts.chaos_soak", "--hard-death-child",
         "--device", device, "--rows", str(rows)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S)
    child_s = time.perf_counter() - t0
    violations: list = []
    if proc.returncode not in (-15, 143):
        violations.append(f"child exited {proc.returncode}, expected death by SIGTERM (-15)")
    for name, stream in (("stdout", proc.stdout), ("stderr", proc.stderr)):
        if "Traceback (most recent call last)" in stream:
            violations.append(f"bare traceback in child {name}: the death handlers must "
                              f"dump, not print")
    qids: list = []
    times: dict = {}
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        qids = obj.get("child_qids") or qids
        times = {k: obj[k] for k in ("t_main", "t_kill") if k in obj} or times
    if not qids:
        violations.append("child never reported its query ids")
    bundles = glob.glob(os.path.join(bb_dir, "blackbox-*.jsonl"))
    sections: dict = {}
    bundle_bytes = None
    if len(bundles) != 1:
        violations.append(f"expected exactly one bundle in {bb_dir}, found "
                          f"{sorted(os.path.basename(b) for b in bundles)}")
    else:
        bundle_bytes = os.path.getsize(bundles[0])
        with open(bundles[0]) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                    sections[obj.pop("section")] = obj
                except (ValueError, KeyError):
                    violations.append("torn line in a dump that was not torn")
        for want in SECTIONS:
            if want not in sections:
                violations.append(f"bundle missing section {want!r}")
            elif set(sections[want]) == {"error"}:
                violations.append(f"section {want!r} failed at dump time: "
                                  f"{sections[want]['error']}")
        meta = sections.get("meta") or {}
        if meta.get("reason") != "sigterm":
            violations.append(f"bundle reason {meta.get('reason')!r}, expected 'sigterm'")
        open_traces = (sections.get("traces") or {}).get("open") or []
        open_ids = {t.get("query_id") for t in open_traces}
        if not [q for q in qids if q in open_ids]:
            violations.append(f"no submitted query ({qids}) has an open timeline in the "
                              f"bundle (open: {sorted(open_ids)})")
        for tr in open_traces:
            if tr.get("complete"):
                violations.append(f"open timeline {tr.get('query_id')} claims complete=true")
            q = (tr.get("spans") or {}).get("query") or {}
            if not q.get("begin", 0) > q.get("end", 0):
                violations.append(f"open timeline {tr.get('query_id')}: `query` span not "
                                  f"marked open (spans={tr.get('spans')})")
        ring = (sections.get("ring") or {}).get("events") or []
        if not any(e.get("type") == "blackbox" and e.get("reason") == "sigterm" for e in ring):
            violations.append("ring section lacks the dump's own blackbox event")
    # The reader by its path: it is stdlib only, and ``-m`` would import
    # the package (and torch) to read a JSON file.
    reader = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "blackbox_read.py"), bb_dir],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=60)
    if reader.returncode != 0:
        violations.append(f"blackbox_read exited {reader.returncode}: "
                          f"{reader.stderr.strip()[:200]}")
    elif qids and not any(q in reader.stdout for q in qids):
        violations.append("blackbox_read's output never names a dead query id")
    schedulers = (sections.get("serve") or {}).get("schedulers") or []
    summary = {
        "metric": "chaos_soak_hard_death",
        "device": device,
        "rows": rows,
        "child_exit": proc.returncode,
        "queries_in_flight": len(qids),
        "bundle_sections": sorted(sections),
        "bundle_bytes": bundle_bytes,
        "open_timelines": len((sections.get("traces") or {}).get("open") or []),
        "serve_queued": sum(s.get("queue_depth", 0) for s in schedulers),
        "serve_reserved_bytes": sum(s.get("reserved_bytes", 0) for s in schedulers),
        # The child's wall: its start to its code running (the package and
        # torch imported), to the kill, to its exit (the dump, the teardown).
        "child_imported_s": times["t_main"] - t_start if times else None,
        "child_to_kill_s": times["t_kill"] - t_start if times else None,
        "elapsed_s": round(child_s, 3),
        "blackbox_dir": bb_dir,
        "ok": not violations,
        "violations": violations,
    }
    print(json.dumps(summary), flush=True)
    return 0 if not violations else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hard-death", action="store_true",
                    help="run the hard-death arm (a SIGTERMed child and its bundle)")
    ap.add_argument("--hard-death-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the child serves (default: the card)")
    ap.add_argument("--rows", type=int, default=2048, help="build and probe rows of the child")
    ap.add_argument("--blackbox-dir", default=None,
                    help="the child's DJT_OBS_BLACKBOX (default: a new temporary directory)")
    args = ap.parse_args(argv)
    if args.hard_death_child:
        return hard_death_child(args.device, args.rows)
    if args.hard_death:
        return hard_death(args.device, args.rows, args.blackbox_dir)
    ap.error("choose an arm: --hard-death (the main walk and the fleet drill are not "
             "ported yet)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
