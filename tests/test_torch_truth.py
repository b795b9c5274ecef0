"""dj_tpu_torch.obs.truth, the device half of dj_tpu's measured truth.

Through fake devices on the ``_device_list`` seam (dj_tpu's
``_FakeDev``), ``sample_device_hbm`` publishes dj_tpu's gauges and
``measured_admission`` dj_tpu's arithmetic; on the CPU (no CUDA device)
both are dj_tpu's documented no-op; the CUDA device object reads the
allocator as chip_smoke's phase 13(b) holds it on the card;
``truth_summary`` keeps dj_tpu's keys; ``tenant_summary`` and
``forecast_scope`` are dj_tpu's.
"""

import pytest
import torch

from dj_tpu.obs import metrics as jmetrics
from dj_tpu.obs import truth as jtruth
import dj_tpu_torch as tj
from dj_tpu_torch import obs as tobs
from dj_tpu_torch.obs import truth as ttruth


class _FakeDev:
    def __init__(self, i, in_use, limit=16e9):
        self.id = i
        self._in_use = int(in_use)
        self._limit = int(limit)

    def memory_stats(self):
        return {"bytes_in_use": self._in_use, "peak_bytes_in_use": self._in_use + 512,
                "bytes_limit": self._limit}


class _OtherProcessDev(_FakeDev):
    """A card another process of the world uses: visible, not sampled."""

    def used(self):
        return False

    def memory_stats(self):
        raise AssertionError("a device this process does not use is never read")


@pytest.fixture
def both(obs_capture, monkeypatch):
    """Both packages' obs on and clean, with the same fake devices."""
    for name in tj.knobs.reset_names():
        monkeypatch.delenv(name, raising=False)
    was = tobs.enabled()
    tobs.reset(reenable=True)
    devs = [_FakeDev(0, 1e9), _FakeDev(1, 2e9)]
    monkeypatch.setattr(jtruth, "_device_list", lambda: devs)
    monkeypatch.setattr(ttruth, "_device_list", lambda: devs)
    yield obs_capture
    tobs.reset(reenable=was)
    tobs.drain()


def _hbm_gauges(summary):
    return {k: v for k, v in summary["gauges"].items() if k.startswith("dj_device_hbm")}


def test_sample_device_hbm_gauges_match_dj_tpu(both):
    got, want = ttruth.sample_device_hbm(), jtruth.sample_device_hbm()
    assert got == want and set(got) == {"0", "1"}
    assert got["1"]["bytes_in_use"] == 2e9
    assert _hbm_gauges(tobs.metrics_summary()) == _hbm_gauges(jmetrics.metrics_summary())
    assert tobs.gauge_value("dj_device_hbm_peak_bytes", device="0") == 1e9 + 512
    tobs.reset(reenable=False)
    assert ttruth.sample_device_hbm() is None  # obs off: telemetry is a no-op
    assert ttruth.sample_device_hbm(force=True) == want


def test_measured_admission_matches_dj_tpu(both, monkeypatch):
    assert ttruth.measured_admission(16e9) is None  # the knob is off
    monkeypatch.setenv("DJ_SERVE_MEASURED_HBM", "1")
    monkeypatch.setenv("DJT_SERVE_MEASURED_HBM", "1")
    m = ttruth.measured_admission(16e9)
    assert m == jtruth.measured_admission(16e9)
    assert m["device"] == "1" and m["headroom_bytes"] == pytest.approx(14e9)
    monkeypatch.setenv("DJ_SERVE_MEASURED_HBM_HEADROOM", "1000000000")
    monkeypatch.setenv("DJT_SERVE_MEASURED_HBM_HEADROOM", "1000000000")
    m = ttruth.measured_admission(16e9)
    assert m == jtruth.measured_admission(16e9) and m["headroom_bytes"] == pytest.approx(13e9)
    assert ttruth.measured_admission(0) is None


def test_no_cuda_device_is_the_graceful_noop(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DJT_SERVE_MEASURED_HBM", "1")
    assert ttruth._device_list() == []
    assert ttruth.sample_device_hbm(force=True) is None
    assert ttruth.measured_admission(16e9) is None
    assert ttruth.truth_summary()["measured_hbm"] is None


def test_a_device_the_process_does_not_use_is_not_sampled(both, monkeypatch):
    devs = [_FakeDev(0, 1e9), _OtherProcessDev(1, 0)]
    monkeypatch.setattr(ttruth, "_device_list", lambda: devs)
    assert set(ttruth.sample_device_hbm()) == {"0"}
    assert tobs.gauge_value("dj_device_hbm_in_use_bytes", None, device="1") is None


class _Props:
    total_memory = 80 * 2**30


def test_the_cuda_device_reads_the_allocator(monkeypatch):
    """What phase 13(b) holds on the card: in use and peak from the
    allocator's allocated_bytes.all, the limit the card's total memory;
    only the devices this process uses (the current one, one it has held
    memory on), and none of them is read through a call that opens a
    context on it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    stats = {0: {"allocated_bytes.all.current": 7, "allocated_bytes.all.peak": 9},
             1: {"allocated_bytes.all.current": 3, "allocated_bytes.all.peak": 3},
             2: {"allocated_bytes.all.current": 0, "allocated_bytes.all.peak": 0}}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats[d])
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: _Props())

    def no_context(d):
        raise AssertionError("mem_get_info opens a context on the device")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_context)
    assert [d.id for d in ttruth._device_list()] == [0, 1, 2]
    got = ttruth.sample_device_hbm(force=True)
    assert got == {"0": {"bytes_in_use": 7, "peak_bytes_in_use": 9, "bytes_limit": 80 * 2**30},
                   "1": {"bytes_in_use": 3, "peak_bytes_in_use": 3, "bytes_limit": 80 * 2**30}}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert ttruth._device_list() == []  # a process that never touched CUDA holds nothing


def test_truth_summary_keeps_dj_tpu_keys(both):
    for mod in (tobs, jmetrics):
        mod.inc("dj_tenant_wire_bytes_total", 100, tenant="a")
        mod.inc("dj_tenant_prepares_total", 2, tenant="b")
        mod.inc("dj_tenant_device_seconds_total", 0.5, tenant="a")
        mod.set_gauge("dj_tenant_index_bytes", 64, tenant="b")
    got, want = ttruth.truth_summary(), jtruth.truth_summary()
    assert set(got) == set(want)
    assert got["measured_hbm"] == want["measured_hbm"]
    assert got["measured_peak_hbm_bytes"] == want["measured_peak_hbm_bytes"] == 2e9 + 512
    assert got["tenants"] == want["tenants"] and set(got["tenants"]) == {"a", "b"}
    assert (got["model_xla_ratio_p50"], got["xla_cost_events"], got["xla_peak_hbm_bytes"]) == \
        (None, 0, {})
    assert ttruth.tenant_summary() == jtruth.tenant_summary()


def test_forecast_scope_nests():
    assert ttruth.current_forecast() is None
    with ttruth.forecast_scope(1e9):
        with ttruth.forecast_scope(0):
            assert ttruth.current_forecast() is None
        with ttruth.forecast_scope(5e8):
            assert ttruth.current_forecast() == 5e8
        assert ttruth.current_forecast() == 1e9
    assert ttruth.current_forecast() is None
