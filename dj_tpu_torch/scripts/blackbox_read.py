"""Print a crash black-box bundle (``dj_tpu_torch.obs.forensics``).

Counterpart of the JAX package's ``scripts/blackbox_read.py``, with the
same output on the same bundle. ``DJT_OBS_BLACKBOX=<dir>`` leaves one
``blackbox-r<rank>-p<pid>.jsonl`` a dead process: one JSON section a
line, the most telling first, written line by line so a dump torn
mid-write loses only its tail. Point this at a bundle (or the directory:
every bundle in it prints, newest first) and it prints:

- why the process died (reason, exception, the traceback's tail) from
  the ``meta`` section;
- what it was doing: every open query timeline as an indented span tree,
  the span the process died inside marked ``OPEN``, and the closed
  timelines' ids;
- the ring's tail, the knobs set explicitly, the metrics' counts, the
  schedulers, the ledger's entries and the last fleet snapshot.

Torn or malformed lines are counted and skipped. Exits 0 when a bundle
held a ``meta`` section, 2 when nothing readable was found.

Usage: python -m dj_tpu_torch.scripts.blackbox_read <bundle.jsonl | dir>
       [--ring-tail N] [--json]

``--json`` prints the parsed sections as one JSON object a bundle.
"""

import argparse
import glob
import json
import os
import sys


def load_bundle(path):
    """Parse one bundle: ({section name: body}, torn lines). A repeated
    section keeps its last line."""
    sections = {}
    torn = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                name = obj.pop("section")
            except (ValueError, KeyError):
                torn += 1
                continue
            sections[str(name)] = obj
    return sections, torn


def _fmt_ts(ts, base):
    try:
        return f"+{float(ts) - base:9.3f}s"
    except (TypeError, ValueError):
        return " " * 11


def print_span_tree(summary, out):
    """One query timeline as an indented tree: spans nest by begin and
    end, phases and instants print at their depth, and a span begun and
    never ended is marked OPEN."""
    events = summary.get("events") or []
    base = None
    for e in events:
        if isinstance(e.get("ts"), (int, float)):
            base = float(e["ts"])
            break
    if base is None:
        base = 0.0
    depth = 0
    open_stack = []
    for e in events:
        ts = _fmt_ts(e.get("ts"), base)
        etype = e.get("type")
        if etype == "span" and e.get("phase") == "begin":
            out.write(f"    {ts} {'  ' * depth}[ {e.get('span', '?')}\n")
            open_stack.append(e.get("span", "?"))
            depth += 1
        elif etype == "span":
            depth = max(0, depth - 1)
            if open_stack:
                open_stack.pop()
            tail = ""
            if e.get("outcome") is not None:
                tail = f" outcome={e['outcome']}"
            if e.get("seconds") is not None:
                tail += f" {e['seconds']:.4f}s"
            out.write(f"    {ts} {'  ' * depth}] {e.get('span', '?')}{tail}\n")
        elif etype == "phase":
            out.write(f"    {ts} {'  ' * depth}~ phase {e.get('phase')}"
                      f" {e.get('seconds', '?')}s"
                      f" roofline={e.get('roofline_frac', '?')}\n")
        else:
            keys = {k: v for k, v in e.items() if k not in ("type", "ts", "query_id", "tenant")}
            out.write(f"    {ts} {'  ' * depth}. {etype} {keys}\n")
    for name in reversed(open_stack):
        out.write(f"    {'':11s} {'  ' * max(0, depth - 1)}"
                  f"] {name}  ** OPEN — process died inside **\n")
        depth = max(0, depth - 1)


def print_bundle(path, sections, torn, out, ring_tail=16):
    out.write(f"== bundle {path}{f'  ({torn} torn line(s) skipped)' if torn else ''}\n")
    meta = sections.get("meta")
    if meta:
        out.write(f"  rank {meta.get('rank')} pid {meta.get('pid')} "
                  f"reason={meta.get('reason')} ts={meta.get('ts')}\n")
        out.write(f"  argv: {' '.join(meta.get('argv') or [])}\n")
        exc = meta.get("exc")
        if exc:
            out.write(f"  exception: {exc.get('type')}: {exc.get('message')}\n")
            tb = (exc.get("traceback") or "").strip().splitlines()
            for ln in tb[-12:]:
                out.write(f"    | {ln}\n")
    traces = sections.get("traces") or {}
    for tr in traces.get("open") or []:
        out.write(f"  OPEN query {tr.get('query_id')} tenant={tr.get('tenant')} "
                  f"orphans={tr.get('orphans')} terminal={tr.get('terminal')}\n")
        print_span_tree(tr, out)
    closed = traces.get("closed") or []
    if closed:
        ids = [t.get("query_id") for t in closed]
        out.write(f"  closed queries ({len(closed)}): {ids}\n")
    ring = (sections.get("ring") or {}).get("events") or []
    if ring:
        out.write(f"  ring: {len(ring)} events; tail:\n")
        for e in ring[-ring_tail:]:
            keys = {k: v for k, v in e.items() if k not in ("type", "ts")}
            out.write(f"    {e.get('type')} {keys}\n")
    knobs = (sections.get("knobs") or {}).get("knobs") or []
    non_default = [k for k in knobs if isinstance(k, dict) and k.get("set")]
    if knobs:
        out.write(f"  knobs: {len(knobs)} registered, {len(non_default)} explicitly set:\n")
        for k in non_default:
            out.write(f"    {k.get('name')}={k.get('effective')!r}\n")
    metrics = sections.get("metrics") or {}
    counters = metrics.get("counters") or {}
    if counters:
        out.write(f"  metrics: {len(counters)} counters, "
                  f"{len(metrics.get('gauges') or {})} gauges\n")
    serve = (sections.get("serve") or {}).get("schedulers")
    if serve:
        for s in serve:
            out.write(f"  scheduler: {s}\n")
    ledger = (sections.get("ledger") or {}).get("entries")
    if ledger:
        out.write(f"  ledger entries: {len(ledger)}\n")
    fleet = (sections.get("fleet") or {}).get("fleet")
    if fleet:
        out.write(f"  last fleet snapshot: {len(fleet.get('ranks') or [])} rank(s)\n")
    for name, body in sections.items():
        if "error" in body and set(body) == {"error"}:
            out.write(f"  section {name}: FAILED at dump time ({body['error']})\n")
        elif set(body) == {"incomplete"}:
            out.write(f"  section {name}: INCOMPLETE at dump time ({body['incomplete']})\n")


def bundle_paths(target):
    """The bundles of ``target``: the file itself, or a directory's
    ``blackbox-*.jsonl`` newest first; [] when there is none."""
    if os.path.isdir(target):
        return sorted(glob.glob(os.path.join(target, "blackbox-*.jsonl")),
                      key=os.path.getmtime, reverse=True)
    return [target] if os.path.exists(target) else []


def main(argv=None):
    ap = argparse.ArgumentParser(description="pretty-print DJT_OBS_BLACKBOX bundles")
    ap.add_argument("target", help="bundle file or bundle directory")
    ap.add_argument("--ring-tail", type=int, default=16, help="ring events to print per bundle")
    ap.add_argument("--json", action="store_true",
                    help="emit parsed sections as JSON per bundle")
    args = ap.parse_args(argv)
    paths = bundle_paths(args.target)
    if not paths:
        print(f"blackbox_read: no bundle at {args.target}", file=sys.stderr)
        return 2
    ok = False
    for path in paths:
        try:
            sections, torn = load_bundle(path)
        except OSError as e:
            print(f"blackbox_read: {path}: {e}", file=sys.stderr)
            continue
        if args.json:
            print(json.dumps({"path": path, "torn": torn, "sections": sections}))
        else:
            print_bundle(path, sections, torn, sys.stdout, args.ring_tail)
        ok = ok or "meta" in sections
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
