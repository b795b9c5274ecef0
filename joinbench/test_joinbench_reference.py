"""The plain reference: right on hand-made joins, in agreement with the
port at tiny sizes, and its controls and comparisons able to fail."""

from __future__ import annotations

import itertools

import pytest
import torch

from joinbench import datagen, reference, spec
from joinbench.control import control_answer
from joinbench.system import Port, valid_rows

CPU = torch.device("cpu")
INT64 = spec.load_kind("int64")
TPCH = spec.load_kind("tpch")


def brute_force(lk, lp, rk, rp) -> list:
    return sorted((int(a), int(b), int(d)) for (a, b), (c, d) in
                  itertools.product(zip(lk, lp), zip(rk, rp)) if a == c)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_join_equals_a_brute_force_join_with_duplicates(seed):
    g = torch.Generator().manual_seed(seed)
    lk = torch.randint(0, 12, (40,), generator=g)
    rk = torch.randint(0, 12, (30,), generator=g)
    lp, rp = torch.arange(40) + 100, torch.arange(30) + 500
    got = reference.join_rows(lk, lp, rk, rp)
    assert sorted(zip(*(c.tolist() for c in got))) == brute_force(lk, lp, rk, rp)


def test_generator_counts_its_matches_exactly():
    inputs = datagen.build_probe(torch.Generator().manual_seed(9), 5000, 7000, 0.3, 10000)
    rows = reference.join_rows(inputs["probe_keys"], inputs["probe_payload"],
                               inputs["build_keys"], inputs["build_payload"])
    assert rows[0].shape[0] == int(inputs["matches"])
    assert inputs["build_keys"].unique().shape[0] == 5000


def test_world_shares_draw_one_world():
    w, n = 4, 3000
    parts = [datagen.world_build_probe(CPU, 5, r, w, n, n, 0.3) for r in range(w)]
    keys, ids = datagen.world_build_side(CPU, 5, w, n)
    assert torch.equal(torch.cat([p["build_keys"] for p in parts]), keys)
    assert torch.equal(torch.cat([p["build_payload"] for p in parts]), ids)
    for p in parts:
        rows = reference.join_rows(p["probe_keys"], p["probe_payload"], keys, ids)
        assert rows[0].shape[0] == int(p["matches"])
        owners = set((rows[2] // n).tolist())
        assert len(owners) == w, "probe rows match build rows of every rank"


@pytest.mark.parametrize("seed", [11, 12])
def test_port_agrees_with_the_reference_int64(seed):
    inputs = datagen.build_probe(datagen.generator(CPU, seed, 0), 20_000, 20_000, 0.3, 40_000)
    port = Port(CPU)
    left, right = INT64.sides(inputs)
    ans = port.join_cols(left, right, port.config({"over_decom_factor": 1}))
    assert not bool(ans.flagged)
    assert int(ans.count) == int(inputs["matches"])
    assert INT64.rows_wrong(inputs, valid_rows(ans)) == 0


@pytest.mark.parametrize("odf", [1, 4])
def test_port_agrees_with_the_reference_tpch(odf):
    inputs = datagen.tpch_split(datagen.generator(CPU, 3, 0), 1, 4000, 1, 7)
    port = Port(CPU)
    left, right = TPCH.sides(inputs)
    ans = port.join_cols(left, right, port.config({"over_decom_factor": odf,
                                                    "char_out_factor": 5.0}))
    assert not bool(ans.flagged)
    assert int(ans.count) == inputs["l_orderkey"].shape[0]
    assert TPCH.rows_wrong(inputs, valid_rows(ans)) == 0


def test_tpch_split_keeps_tpch_laws():
    inputs = datagen.tpch_split(datagen.generator(CPU, 4, 0), 2, 8000, 1, 7)
    ok = inputs["o_orderkey"]
    assert ok.unique().shape[0] == 8000
    assert bool(((ok - 1) % 32 < 8).all()), "dbgen's sparse orderkeys"
    per_order = torch.bincount(torch.searchsorted(ok.sort().values, inputs["l_orderkey"]))
    assert int(per_order.min()) >= 1 and int(per_order.max()) <= 7
    off, chars = inputs["o_orderpriority"]
    words = {bytes(chars[int(off[i]):int(off[i + 1])].tolist()).decode() for i in range(50)}
    assert words <= set(datagen.PRIORITIES)


def test_comparisons_see_one_altered_byte_or_row():
    inputs = datagen.tpch_split(datagen.generator(CPU, 5, 0), 0, 2000, 1, 7)
    keys, view = TPCH.expected_rows(inputs)
    off, chars, rows = view
    got_off, got_chars = reference.truncate_strings(off, chars, rows, width=64)
    assert reference.keyed_string_rows_wrong(keys, (got_off, got_chars, torch.arange(
        keys.shape[0])), keys, view) == 0
    bad = got_chars.clone()
    bad[3] ^= 1
    assert reference.keyed_string_rows_wrong(keys, (got_off, bad, torch.arange(
        keys.shape[0])), keys, view) == 1
    cols = reference.join_rows(torch.arange(10), torch.arange(10), torch.arange(10),
                               torch.arange(10) + 7)
    worse = [c.clone() for c in cols]
    worse[2][4] += 1
    assert reference.rows_wrong_int(worse, cols) == 1
    assert reference.rows_wrong_int([c[:-1] for c in cols], cols) == 1


def test_int64_control_fails_at_a_size_a_test_holds():
    """32 bits of a hash over 1M x 1M rows: a few hundred false pairs."""
    inputs = datagen.build_probe(datagen.generator(CPU, 21, 0), 1_000_000, 1_000_000, 0.3,
                                 2_000_000)
    left, right = INT64.sides(inputs)
    ans = control_answer(INT64, "hash32_keys", left, right)
    assert int(ans.count) > int(inputs["matches"])
    assert INT64.rows_wrong(inputs, valid_rows(ans)) > 0


def test_tpch_control_fails():
    inputs = datagen.tpch_split(datagen.generator(CPU, 22, 0), 0, 4000, 1, 7)
    left, right = TPCH.sides(inputs)
    ans = control_answer(TPCH, "truncate_strings", left, right)
    assert int(ans.count) == inputs["l_orderkey"].shape[0]
    assert TPCH.rows_wrong(inputs, valid_rows(ans)) > 0
