"""The soak's fleet drill on CPU ranks, against dj_tpu's settled plan.

``python -m dj_tpu_torch.scripts.chaos_soak --fleet --device cpu`` runs
the drill of dj_tpu's ``scripts/chaos_soak.py:1062-1438`` with subprocess
peers sharing one ``DJT_FLEET_DIR``: its summary is ``ok`` with one peer
defer and no duplicate prepare, one lease reclaimed from a SIGKILLed
holder, and a replay of the dead owner's healed plan with no
prepare-stage heal. The factors phase 3's peer settles are those that
dj_tpu's ``JoinIndexCache`` settles for the same skewed build side on
its 8-device CPU mesh. A file of its own: its children are processes,
and it should not share a worker with the walk.
"""

import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def drill():
    proc = subprocess.run(
        [sys.executable, "-m", "dj_tpu_torch.scripts.chaos_soak", "--fleet", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return proc, (json.loads(lines[-1]) if lines else {})


def test_drill_holds_its_three_phases(drill):
    proc, summary = drill
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    assert summary["metric"] == "chaos_soak_fleet" and summary["ok"], summary
    assert summary["violations"] == [] and "Traceback" not in proc.stderr
    phases = summary["phases"]
    assert phases["defer"] == {"defers": 1, "duplicate_prepares": 0}
    assert phases["reclaim"] == {"reclaims": 1}
    assert phases["replay"]["replays"] >= 1 and phases["replay"]["prepare_heals"] == 0
    assert summary["outcomes"] == {"result": 3} and summary["children"] == 3
    assert (summary["device"], summary["rows"], summary["world"]) == ("cpu", 2048, 8)


def test_replayed_factors_are_the_ones_dj_tpu_settles(drill):
    _, summary = drill
    spec = importlib.util.spec_from_file_location("jax_chaos_soak",
                                                  ROOT / "scripts" / "chaos_soak.py")
    walk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(walk)
    from dj_tpu.cache import IndexConfig, JoinIndexCache
    from dj_tpu.parallel.dist_join import _config_factors

    topo, left, lc, right, rc, cfg, _ = walk._fleet_tables(64, skew=True)
    cache = JoinIndexCache(IndexConfig(hbm_budget_bytes=500e6))
    lease = cache.get_or_prepare(topo, right, rc, [0], cfg, left_capacity=left.capacity)
    want = _config_factors(lease.prepared.config)
    lease.release()
    cache.clear()
    factors = summary["phases"]["replay"]["factors"]
    assert factors == json.loads(json.dumps(want))
    assert factors["bucket_factor"] > 4.0  # the peer's prepare healed
