"""A CPU rehearsal of chip_smoke's phase 17 (the soak on the card).

``run_soak`` with the card stubbed and the kernel wrappers counting
their plain calls (the ``cs`` fixture of ``test_torch_smoke_prepared.py``),
at 2048 rows, a walk of three of its specs (the baseline, a prepared
tier's site and a fleet site: the whole walk is the CLI's, and
``tests/test_torch_soak.py`` holds a slice of it to dj_tpu's) and a
20,000-row native pair: the walk and the drill pass,
each of the path's four kernels is called by the walk, murmur3 of the
build keys agrees between the native library and the port's hash, and
the native-generated join gives ``expected_match_count`` exactly. A
file of its own, apart from the walk's and the drill's tests.
"""

import functools

import torch

import dj_tpu_torch as tj
from dj_tpu_torch.scripts import chaos_soak
from test_torch_smoke_prepared import _dj, cs  # noqa: F401 - the fixture


def test_chip_smoke_soak_phase_rehearses_on_cpu(cs, monkeypatch, capsys):  # noqa: F811
    monkeypatch.setattr(cs, "SOAK_ROWS", 2048)
    monkeypatch.setattr(cs, "NATIVE_ROWS", 20_000)
    specs = (None, "bc_prepared_query@call=1", "fleet.publish@call=1")
    monkeypatch.setattr(chaos_soak, "FAULT_WALK", specs)
    monkeypatch.setattr(chaos_soak, "main_walk", functools.partial(chaos_soak.main_walk,
                                                                   specs=specs))
    dj = _dj()
    gen = torch.Generator().manual_seed(0)
    build, _ = dj.generate_build_probe_tables(gen, 20_000, 20_000, 0.3, 40_000, True)
    launches = cs.run_soak(dj, torch.device("cpu"), build, 100_000, 0, "cpu rehearsal")
    assert set(launches) == {"walk", "drill", "native_join"}
    assert all(launches["walk"][k] > 0 for k in cs.PATH_KERNELS), launches
    assert launches["native_join"]["join_scans"] == 1
    out = capsys.readouterr().out
    assert '"metric": "chaos_soak"' in out and '"metric": "chaos_soak_fleet"' in out
    assert '"case": "(c) native"' in out or "(c) native" in out
    assert not tj.resilience.pinned_tiers() and cs.child_pids() == []
