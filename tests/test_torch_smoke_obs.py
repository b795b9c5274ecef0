"""A CPU rehearsal of chip_smoke's phase 11 (observability on the main
path) at 20,000 rows, with every check as on the card (``cs``: the card
stubbed, the kernel wrappers counting their plain calls). The CPU has no
sync debug mode and its profiler sees no device kernel, so those two
are stubbed: the sync count is 0 both ways, and the kernels inside
dj_join are the kernel wrappers' names."""

import pytest  # noqa: F401 - the cs fixture below is a pytest fixture
import torch

import dj_tpu_torch as tj

from test_torch_smoke_prepared import _dj, _main_path, cs  # noqa: F401 - cs is a fixture


def test_chip_smoke_observability_phase_rehearses_on_cpu(cs, capsys, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    real = cs.range_kernels

    def with_kernels(prof, name):
        kernels, span, n = real(prof, name)  # the CPU trace holds the ranges, no kernel
        return {**kernels, "join_scans_kernel": 0.0, "expand_values_kernel": 0.0}, span, n

    monkeypatch.setattr(cs, "range_kernels", with_kernels)
    dj = _dj()
    rows = 20_000
    _, build, probe, expected, topo, left, lcnt, right, rcnt, ref = _main_path(cs, dj, rows)
    got = cs.run_observability(dj, torch.device("cpu"), topo, left, lcnt, right, rcnt, build,
                               probe, expected, ref, rows, "cpu")
    assert got["world4_auto_obs"][1]["join_scans"] == 2 * cs.WORLD  # two attempts a rank
    out = capsys.readouterr().out
    assert out.count("[obs_overhead]") == 2
    for line in ("[obs_healed_join]", "[obs_profile]"):
        assert line in out
    assert not tj.obs.enabled()
