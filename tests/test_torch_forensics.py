"""dj_tpu_torch.obs.forensics (the crash black box), its reader and the
soak's hard-death arm, against dj_tpu's.

- ``arm`` / ``dump`` / ``disarm`` as dj_tpu's ``tests/test_fleet_obs.py:446``,
  through both packages: the section order, the meta and exception
  record, the open span marked, the dump's own closing ``blackbox``
  event, the handlers restored; a failing section's stub line; the env
  switch and an unwritable directory.
- ``:490``, the torn tail: a bundle the port wrote, its last line cut,
  read by the port's reader and by dj_tpu's ``scripts/blackbox_read.py``
  (both stdlib only, run as subprocesses): the same ``--json`` and the
  same text. An empty directory exits 2.
- The death handlers in a child process: SIGTERM with ``fleet.drain``'s
  handler installed before and after the black box's (the bundle is
  dumped, the drain begins, the exit still says SIGTERM), an uncaught
  exception, a clean exit; ``arm`` from another thread leaves SIGTERM
  alone.
- ``:536``, the hard-death arm, on the CPU (``--device cpu``).
"""

import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest

import dj_tpu.obs as jobs
import dj_tpu_torch.obs as tobs
from dj_tpu.obs import forensics as jfor
from dj_tpu_torch.obs import forensics as tfor
from dj_tpu_torch.scripts import blackbox_read, chaos_soak

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_READER = REPO / "dj_tpu_torch" / "scripts" / "blackbox_read.py"
JAX_READER = REPO / "scripts" / "blackbox_read.py"
PKGS = {"dj_tpu": (jobs, jfor, "DJ_"), "dj_tpu_torch": (tobs, tfor, "DJT_")}


@pytest.fixture
def both():
    was = {k: p[0].enabled() for k, p in PKGS.items()}
    for obs, forensics, _ in PKGS.values():
        forensics.disarm()
        obs.reset(reenable=True)
        obs.drain()
    yield
    for k, (obs, forensics, _) in PKGS.items():
        forensics.disarm()
        obs.reset(reenable=was[k])
        obs.drain()


def _read_bundle(path):
    sections = {}
    with open(path) as f:
        for line in f:
            obj = json.loads(line)
            sections[obj.pop("section")] = obj
    return sections


def _run(*argv, env=None, timeout=120):
    return subprocess.run([sys.executable, *map(str, argv)], capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=env)


def test_arm_dump_disarm_matches_dj_tpu(both, tmp_path):
    got = {}
    for pkg, (obs, forensics, prefix) in PKGS.items():
        prev_hook = sys.excepthook
        path = forensics.arm(str(tmp_path / pkg))
        assert sys.excepthook is not prev_hook
        assert forensics.armed_dir() == str(tmp_path / pkg)
        assert os.path.basename(path) == f"blackbox-r0-p{os.getpid()}.jsonl"
        with obs.query_ctx("0:q-dead-1"):
            obs.span_begin("query")
        assert forensics.dump("excepthook", ValueError("boom")) == path
        forensics.disarm()
        assert sys.excepthook is prev_hook and forensics.armed_dir() is None
        assert forensics.bundle_path() is None and forensics.dump("after-disarm") is None
        s = _read_bundle(path)
        meta = {k: v for k, v in s["meta"].items() if k != "ts"}
        meta["exc"] = {k: v for k, v in meta["exc"].items() if k != "traceback"}
        ring = [{k: v for k, v in e.items() if k not in ("seq", "ts", "path", "dir")}
                for e in s["ring"]["events"]]
        opened = [{k: v for k, v in t.items() if k != "events"} for t in s["traces"]["open"]]
        # The serve section lists each package's live schedulers, which
        # earlier tests in the process may have left: compared by shape.
        got[pkg] = (list(s), meta, opened, ring, s["traces"]["closed"], list(s["serve"]),
                    s["fleet"], any(k["name"] == f"{prefix}OBS_BLACKBOX" and k["set"]
                                    for k in s["knobs"]["knobs"]))
    assert got["dj_tpu_torch"] == got["dj_tpu"]
    order, meta, opened, ring = got["dj_tpu_torch"][:4]
    assert order == ["meta", "traces", "ring", "metrics", "knobs", "serve", "ledger", "fleet",
                     "coordination"]
    assert meta["reason"] == "excepthook" and meta["exc"] == {"type": "ValueError",
                                                             "message": "boom"}
    assert opened[0]["query_id"] == "0:q-dead-1" and opened[0]["complete"] is False
    assert opened[0]["spans"]["query"] == {"begin": 1, "end": 0}
    assert ring[-1] == {"type": "blackbox", "action": "dump", "reason": "excepthook"}


def test_a_failing_section_leaves_a_stub_line_in_both(both, tmp_path, monkeypatch):
    got = {}
    for pkg, (obs, forensics, _) in PKGS.items():
        def boom(*a, **k):
            raise RuntimeError("mid-teardown")

        monkeypatch.setattr(forensics._trace, "blackbox_traces", boom)
        path = forensics.arm(str(tmp_path / pkg))
        forensics.dump("sigterm")
        forensics.disarm()
        s = _read_bundle(path)
        got[pkg] = (list(s), s["traces"])
    assert got["dj_tpu_torch"] == got["dj_tpu"]
    assert got["dj_tpu_torch"][1] == {"error": "RuntimeError"}


def test_arm_from_env_and_an_unwritable_directory_match_dj_tpu(both, tmp_path, monkeypatch):
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    got = {}
    for pkg, (obs, forensics, prefix) in PKGS.items():
        monkeypatch.delenv(prefix + "OBS_BLACKBOX", raising=False)
        unset = forensics.maybe_arm_from_env()
        monkeypatch.setenv(prefix + "OBS_BLACKBOX", str(blocker / "sub"))
        with pytest.warns(UserWarning, match=f"{prefix}OBS_BLACKBOX="):
            bad = forensics.maybe_arm_from_env()
        monkeypatch.setenv(prefix + "OBS_BLACKBOX", str(tmp_path / pkg))
        good = forensics.maybe_arm_from_env()
        got[pkg] = (unset, bad, [e["name"] for e in obs.events("warning")],
                    os.path.basename(good), forensics.armed_dir() == str(tmp_path / pkg))
        forensics.disarm()
    assert got["dj_tpu_torch"] == got["dj_tpu"]
    assert got["dj_tpu_torch"][:3] == (None, None, ["obs_blackbox_arm_failed"])


def test_arm_from_another_thread_leaves_sigterm_alone(both, tmp_path):
    import signal

    before = signal.getsignal(signal.SIGTERM)
    hooks = []
    th = threading.Thread(target=lambda: hooks.append(tfor.arm(str(tmp_path))))
    th.start()
    th.join(timeout=30)
    try:
        assert hooks and sys.excepthook is tfor._on_uncaught
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        tfor.disarm()
    assert sys.excepthook is not tfor._on_uncaught


def _torn_bundle(tmp_path):
    path = tfor.arm(str(tmp_path))
    try:
        with tobs.query_ctx("0:q-torn-1"):
            tobs.span_begin("query")
            tobs.record("admission", decision="admit")
        tobs.record("t_mark", n=3)
        tfor.dump("excepthook", RuntimeError("torn"))
    finally:
        tfor.disarm()
    lines = pathlib.Path(path).read_text().splitlines()
    pathlib.Path(path).write_text("\n".join(lines[:-1]) + "\n" + lines[-1][:30])
    return path


def test_both_readers_read_the_ports_torn_bundle_alike(both, tmp_path):
    path = _torn_bundle(tmp_path)
    outs = {}
    for name, reader in (("port", PORT_READER), ("dj_tpu", JAX_READER)):
        as_json = _run(reader, tmp_path, "--json")
        pretty = _run(reader, path, "--ring-tail", "4")
        assert as_json.returncode == 0 and pretty.returncode == 0, (as_json.stderr,
                                                                     pretty.stderr)
        outs[name] = (as_json.stdout, pretty.stdout)
    assert outs["port"] == outs["dj_tpu"]
    (out,) = [json.loads(ln) for ln in outs["port"][0].splitlines()]
    assert out["torn"] == 1 and out["sections"]["meta"]["exc"]["type"] == "RuntimeError"
    assert "coordination" not in out["sections"]  # the torn last line
    text = outs["port"][1]
    assert "0:q-torn-1" in text and "torn line(s) skipped" in text and "OPEN" in text


def test_the_reader_exits_2_on_nothing_readable(tmp_path, capsys):
    """An empty directory, and a bundle of torn lines alone, exit 2 (the
    hard-death arm runs the reader as ``python -m``)."""
    assert blackbox_read.main([str(tmp_path)]) == 2
    assert "no bundle at" in capsys.readouterr().err
    bad = tmp_path / "blackbox-r0-p1.jsonl"
    bad.write_text("not json\n")
    assert blackbox_read.main([str(bad)]) == 2
    assert "1 torn line(s) skipped" in capsys.readouterr().out


CHILD = """
import os, signal, sys, time
sys.path.insert(0, {repo!r})
from dj_tpu_torch import obs
from dj_tpu_torch.fleet import drain
from dj_tpu_torch.obs import forensics
how, bb = sys.argv[1], sys.argv[2]
obs.enable()
if how == "drain_first":
    drain.install()
    forensics.arm(bb)
elif how in ("blackbox_first", "raise", "exit"):
    forensics.arm(bb)
    if how == "blackbox_first":
        drain.install()
with obs.query_ctx("0:q-term-1"):
    obs.span_begin("query")
print("ready", flush=True)
if how == "raise":
    raise KeyError("uncaught")
if how == "exit":
    sys.exit(0)
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(30)
sys.exit(3)
"""


@pytest.mark.parametrize("how", ["drain_first", "blackbox_first", "raise", "exit"])
def test_death_handlers_in_a_child(how, tmp_path):
    """SIGTERM with fleet.drain's handler before and after the black
    box's: the bundle is dumped, the drain begins (its events reach the
    DJT_OBS_LOG sink) and the exit still says SIGTERM. An uncaught
    exception dumps with the exception and still prints its traceback;
    a clean exit dumps at exit."""
    bb, log = tmp_path / "bb", tmp_path / "events.jsonl"
    env = dict(os.environ, DJT_OBS_LOG=str(log), DJT_FLEET_DRAIN_GRACE_S="0")
    proc = _run("-c", CHILD.format(repo=str(REPO)), how, bb, env=env)
    (bundle,) = bb.glob("blackbox-r0-p*.jsonl")
    s = _read_bundle(bundle)
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    kinds = [(e["type"], e.get("phase") or e.get("action")) for e in events
             if e["type"] in ("drain", "blackbox")]
    assert list(s) == ["meta", "traces", "ring", "metrics", "knobs", "serve", "ledger", "fleet",
                       "coordination"]
    assert [t["query_id"] for t in s["traces"]["open"]] == ["0:q-term-1"]
    if how in ("drain_first", "blackbox_first"):
        assert proc.returncode == -15, (proc.stdout, proc.stderr)
        assert s["meta"]["reason"] == "sigterm" and "Traceback" not in proc.stderr
        assert ("drain", "begin") in kinds and ("blackbox", "dump") in kinds
        # The handler installed last runs first.
        first = ("drain", "begin") if how == "blackbox_first" else ("blackbox", "dump")
        assert kinds.index(first) < kinds.index(
            ("blackbox", "dump") if first[0] == "drain" else ("drain", "begin"))
    elif how == "raise":
        assert proc.returncode == 1 and "KeyError: 'uncaught'" in proc.stderr
        assert s["meta"]["reason"] == "excepthook" and s["meta"]["exc"]["type"] == "KeyError"
        assert kinds.count(("blackbox", "dump")) == 1  # atexit stood down
    else:
        assert proc.returncode == 0 and s["meta"]["reason"] == "atexit"


def test_hard_death_arm_on_the_cpu(tmp_path):
    """dj_tpu's test_fleet_obs.py:536 on the port: the child serves on
    CPU tensors and dies by SIGTERM with its queries in flight; the
    auditor's five checks hold."""
    proc = _run("-m", "dj_tpu_torch.scripts.chaos_soak", "--hard-death", "--device", "cpu",
                "--blackbox-dir", tmp_path / "bb", timeout=300)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    (summary,) = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert summary["metric"] == "chaos_soak_hard_death" and summary["ok"] is True, summary
    assert summary["child_exit"] in (-15, 143) and summary["queries_in_flight"] == 4
    assert summary["open_timelines"] >= 1 and summary["bundle_bytes"] > 0
    assert summary["bundle_sections"] == sorted(["meta", "traces", "ring", "metrics", "knobs",
                                                 "serve", "ledger", "fleet", "coordination"])
    assert summary["serve_queued"] + summary["serve_reserved_bytes"] > 0


def test_soak_help_names_its_three_arms(capsys):
    """The walk is the default arm; --fleet and --hard-death the others."""
    with pytest.raises(SystemExit) as e:
        chaos_soak.main(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert e.value.code == 0
    assert "the main walk (the default)" in out
    assert "--fleet" in out and "fleet drill" in out
    assert "--hard-death" in out and "hard-death arm" in out
