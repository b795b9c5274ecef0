"""The local join's merged-sort forms through ``distributed_inner_join``,
against the benchmark's plain reference (``joinbench.reference``): two
int64 keys whose spans do not fit the packed word beside the row tag
take the unpacked lexicographic sort, narrow spans the packed multi-key
word, one key the packed word. Each gives the reference's rows, counts
its form in ``dj_join_sort_total{form}`` once a local join, and only the
unpacked form records its passes as ``dj_join/lex_sort`` and
``dj_join/run_ids`` inside ``dj_join``."""

import numpy as np
import pytest
import torch

import dj_tpu_torch as tj
from dj_tpu_torch import obs
from dj_tpu_torch.parallel import spmd
from joinbench import reference

# Key bits a form's key columns span: 41 + 20 + the tag's 13 bits pass 64.
FORMS = {"unpacked": (41, 20), "multi_packed": (10, 8), "packed": (41,)}
LEX_SPANS = {"dj_join/lex_sort", "dj_join/run_ids"}


@pytest.fixture(autouse=True)
def _one_thread_obs_on(monkeypatch):
    for name in tj.knobs.reset_names():
        monkeypatch.delenv(name, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    was = obs.enabled()
    obs.reset(reenable=True)
    tj.resilience.ledger.reset()
    yield
    obs.reset(reenable=was)
    obs.drain()
    tj.resilience.ledger.reset()
    torch.set_num_threads(threads)


def _tables(bits, seed, n_left=3000, n_right=2000):
    """(left, right) columns: the keys, then a row id. Right keys draw
    from each span, its ends included; 70% of the left rows take a right
    row's keys, the rest draw again."""
    rng = np.random.default_rng(seed)
    right = []
    for b in bits:
        k = rng.integers(0, 2**b, n_right)
        k[:2] = (0, 2**b - 1)
        right.append(k)
    hit = rng.random(n_left) < 0.7
    pick = rng.integers(0, n_right, n_left)
    left = [np.where(hit, r[pick], rng.integers(0, 2**b, n_left)) for r, b in zip(right, bits)]
    left.append(np.arange(n_left))
    right.append(np.arange(n_right) + 10**6)
    return ([torch.from_numpy(c.astype(np.int64)) for c in left],
            [torch.from_numpy(c.astype(np.int64)) for c in right])


@pytest.mark.parametrize("odf", [1, 4])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_each_sort_form_gives_the_references_rows(form, odf):
    bits = FORMS[form]
    k = len(bits)
    left, right = _tables(bits, seed=len(form) * 7 + odf)
    topo = tj.make_topology(["cpu"])
    (l, lc), (r, rc) = (tj.shard_table(topo, tj.from_arrays(*[c.numpy() for c in t],
                                                             device="cpu"))
                        for t in (left, right))
    on = list(range(k))
    with spmd.record_phases() as runs:
        out, counts, info = tj.distributed_inner_join(
            topo, l, lc, r, rc, on, on, tj.JoinConfig(over_decom_factor=odf, join_out_factor=2.0))
    assert not any(bool(v.any()) for v in info.values() if v.dtype == torch.bool)
    n = int(counts.sum())
    got = sorted(zip(*[c.data[:n].tolist() for c in out.columns]))
    li, ri = reference.match_pairs(left[:k], right[:k])
    want = sorted(zip(*[c[li].tolist() for c in left], right[k][ri].tolist()))
    assert n == len(want) > 1000
    assert got == want
    assert obs.counter_value("dj_join_sort_total", form=form) == odf
    assert sum(obs.counter_series("dj_join_sort_total").values()) == odf
    (ranks,) = runs
    assert "dj_join/sort" in ranks[0]
    if form == "unpacked":
        assert LEX_SPANS <= set(ranks[0])
        assert all(ranks[0][s] <= ranks[0]["dj_join/sort"] for s in LEX_SPANS)
    else:
        assert not LEX_SPANS & set(ranks[0])
