"""A CPU rehearsal of chip_smoke's phases of the composition layers: the
warmups, 4j (a chain with a local stage), 4k (the coalesced unprepared
dispatch with shape buckets), 5f (the coalesced prepared dispatch) and
8g (TPC-H Q3 as one pipeline), at a tiny size on CPU tables with every
check as on the card (``cs``: the card stubbed, the kernel wrappers
counting their plain calls). 6a's warmup and 6b's chain rehearse with
the process worlds (``tests/test_torch_process_world.py``).
"""

import pytest  # noqa: F401 - the cs fixture below is a pytest fixture
import torch

from test_torch_smoke_prepared import _dj, _main_path, cs  # noqa: F401 - cs is a fixture


def test_chip_smoke_chain_and_bucket_phases_rehearse_on_cpu(cs, capsys):  # noqa: F811
    dj = _dj()
    rows = 20_000
    _, build, probe, expected, _, _, _, _, _, ref = _main_path(cs, dj, rows)
    warm = cs.run_warmups(dj, "cpu", "cpu")
    assert warm["two_level"]["axes"] == ["inter", "intra"]
    chain = cs.run_pipeline_chain(dj, "cpu", build, probe, expected, ref, rows, "cpu")
    assert chain["pipeline_local_chain"][4]["join_scans"] == cs.WORLD * 4 + cs.WORLD
    assert chain["pipeline_reshuffle_chain"][4]["join_scans"] == 2 * cs.WORLD * 4
    bucketed = cs.run_coalesced_bucketed(dj, "cpu", build, probe, rows, "cpu")
    assert bucketed["coalesced_unprepared_bucketed"][1]["expand_values"] == cs.WORLD ** 2
    out = capsys.readouterr().out
    for line in ("[warmup_all_to_all]", "[pipeline_chain]", "[coalesced_bucketed]"):
        assert line in out


def test_chip_smoke_coalesced_prepared_phase_rehearses_on_cpu(cs, capsys):  # noqa: F811
    dj = _dj()
    rows = 20_000
    gen, build, probe, expected, _, _, _, _, _, ref = _main_path(cs, dj, rows)
    got = cs.run_coalesced_prepared(dj, "cpu", gen, build, probe, expected, ref, rows, "cpu")
    assert got["coalesced_prepared_shuffle_merge"][4]["merge_sorted_u64"] == cs.WORLD * 4 * 4
    assert got["coalesced_prepared_broadcast_probe"][1]["expand_ranks"] == cs.WORLD * 4
    assert capsys.readouterr().out.count("[coalesced_prepared]") == 9


def test_chip_smoke_q3_pipeline_phase_rehearses_on_cpu(cs, capsys):  # noqa: F811
    dj = _dj()
    orders, lineitem, customer, n_cust = cs.tpch_tables(dj, torch.device("cpu"), 0, 4000)
    one, world = cs.run_q3_pipeline(dj, torch.device("cpu"), orders, lineitem, customer, n_cust,
                                    "cpu")
    assert one["tpch_q3_pipeline"][1]["join_scans"] == 2  # one attempt a stage
    assert world["tpch_q3_pipeline"][1]["join_scans"] == 2 * cs.WORLD
    assert capsys.readouterr().out.count("[tpch_q3_pipeline]") == 2
