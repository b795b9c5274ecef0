"""dj_tpu_torch.knobs: the registry holds every DJT_* name the port
reads, each one is read somewhere and documented in README's port
section, its readers keep their defaults, and ``reset_names()`` lists
the names a test clears."""

import pathlib
import re

import pytest

from dj_tpu_torch import knobs

REPO = pathlib.Path(__file__).resolve().parent.parent
NAME = re.compile(r"DJT_[A-Z0-9_]+")


def _sources():
    files = sorted((REPO / "dj_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    return {f: f.read_text() for f in files}


def _port_section() -> str:
    text = (REPO / "README.md").read_text()
    start = text.index("## PyTorch/CUDA port")
    return text[start:]


def test_every_djt_literal_is_registered():
    seen = {}
    for f, text in _sources().items():
        for name in NAME.findall(text):
            seen.setdefault(name, f.relative_to(REPO).as_posix())
    unregistered = {n: f for n, f in seen.items() if n not in knobs.REGISTRY}
    assert unregistered == {}


def test_every_registered_knob_is_read_somewhere():
    code = "\n".join(t for f, t in _sources().items() if f.name != "knobs.py")
    unread = [k.name for k in knobs.KNOBS if f'"{k.name}"' not in code]
    assert unread == []


def test_every_knob_is_documented_in_the_port_section_of_the_readme():
    section = _port_section()
    assert [k.name for k in knobs.KNOBS if k.name not in section] == []


def test_registry_shape():
    assert len(knobs.KNOBS) == len(knobs.REGISTRY) == 64
    for k in knobs.KNOBS:
        assert k.doc and k.kind in ("bool", "int", "float", "str", "enum", "path")
        assert (k.kind == "enum") == bool(k.choices)
    obs_names = {"DJT_OBS", "DJT_OBS_LOG", "DJT_OBS_RING", "DJT_OBS_TRACES",
                 "DJT_PEAK_HBM_GBPS", "DJT_PEAK_WIRE_GBPS"}
    assert obs_names <= set(knobs.REGISTRY)
    assert knobs.REGISTRY["DJT_PEAK_HBM_GBPS"].default == 3350.0
    assert knobs.REGISTRY["DJT_PEAK_WIRE_GBPS"].default == 450.0
    # The scheduler's family carries dj_tpu's defaults (dj_tpu/knobs.py:208-232).
    serve = {"DJT_SERVE_HBM_BUDGET": 16e9, "DJT_SERVE_QUEUE_DEPTH": 64,
             "DJT_SERVE_DEADLINE_S": None, "DJT_SERVE_COALESCE": "1",
             "DJT_SERVE_COALESCE_MAX": 8, "DJT_SERVE_PRESSURE_WINDOW": 32,
             "DJT_SERVE_PRESSURE_REJECT_RATE": 0.5, "DJT_SERVE_MATCH_FACTOR": 1.0,
             "DJT_SERVE_SLO_WINDOW": 128, "DJT_SERVE_DRIFT_THRESHOLD": 2.0}
    assert {n: knobs.REGISTRY[n].default for n in serve} == serve
    assert all(knobs.REGISTRY[n].cleanup == "serve" for n in serve)


def test_readers_keep_their_defaults(monkeypatch):
    for k in knobs.KNOBS:
        monkeypatch.delenv(k.name, raising=False)
    assert knobs.read("DJT_JOIN_EXPAND") == "vmeta"
    assert knobs.read("DJT_JOIN_MERGE") == "sort"
    assert knobs.read("DJT_PROBE_EXPAND") == "segment"
    assert knobs.read("DJT_JOIN_PACK") == "1" and knobs.read("DJT_JOIN_CARRY") == "0"
    assert knobs.read("DJT_PREPARED_TIER") is None and knobs.read("DJT_LEDGER") is None
    assert knobs.read_float("DJT_SALT_RATIO") == 2.0 and knobs.read_int("DJT_SALT_TOPK") == 3
    assert knobs.read_int("DJT_OBS_RING") == 1024 and knobs.read_int("DJT_OBS_TRACES") == 256
    assert not knobs.read_bool("DJT_PLAN_ADAPT")
    monkeypatch.setenv("DJT_SALT_RATIO", "oops")
    assert knobs.read_float("DJT_SALT_RATIO") == 2.0  # malformed: the default
    monkeypatch.setenv("DJT_PLAN_ADAPT", "Yes")
    assert knobs.read_bool("DJT_PLAN_ADAPT")
    assert knobs.read("DJT_JOIN_MERGE", None) is None
    with pytest.raises(KeyError):
        knobs.read("DJT_NOT_A_KNOB")
    snap = {s["name"]: s for s in knobs.registry_snapshot()}
    assert snap["DJT_SALT_RATIO"]["malformed"] and snap["DJT_SALT_RATIO"]["effective"] == 2.0
    assert snap["DJT_PLAN_ADAPT"]["effective"] is True and snap["DJT_PLAN_ADAPT"]["set"]


def test_reset_names_clears_them(monkeypatch):
    names = knobs.reset_names()
    assert {"DJT_PLAN_ADAPT", "DJT_PREPARED_TIER", "DJT_SHAPE_BUCKET", "DJT_LEDGER",
            "DJT_SERVE_HBM_BUDGET", "DJT_PIPELINE_BROADCAST", "DJT_FAULT"} <= set(names)
    assert not {"DJT_JOIN_EXPAND", "DJT_OBS", "DJT_COORDINATOR_ADDRESS"} & set(names)
    for n in names:
        monkeypatch.setenv(n, "1")
    for n in names:
        monkeypatch.delenv(n)
    assert all(knobs.read(n) == knobs.REGISTRY[n].default for n in names)
