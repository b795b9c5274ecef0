"""dj_tpu_torch's distributed_inner_join on the new key kinds vs dj_tpu's,
at a world of 1 and an in-process world of 4.

The key kinds of ``tests/test_torch_join_keys.py`` (mixed dtypes, floats
with -0.0, NaN and +-inf, 2 and 3 columns packed through a declared range
and unpacked, a 64-bit span that sorts unpacked, carry) go through
``distributed_inner_join`` in both packages at odf 2, dj_tpu on as many
devices of the CPU mesh: the range probe, the hash partition, the
exchange and the local join of each kind. The hash is bit exact, so
shard r holds the same rows in both: compared are the [w] counts, the
bool[w] flags and each shard's row multiset. uint64 keys hash
differently from their int64 image, so a uint64 kind is held to
dj_tpu's join of the keys less 2^63 on the whole result (total, flags
and the unsharded row multiset; dj_tpu cannot join a uint64 key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dj_tpu
from dj_tpu.parallel.api import shard_table as jshard
from dj_tpu.parallel.topology import make_topology as jmake_topology
import dj_tpu_torch as tj
from dj_tpu_torch import convert
from test_torch_join_keys import _as_int64_keys, _cell, _kind

KINDS = ["mixed_int16_int64", "floats_float64", "two_keys_packed", "two_keys_unpacked",
         "three_keys_packed", "wide_observed", "carry_int64"]


def _valid(side):
    arrays, names, valid, _ = side
    return [np.asarray(a)[:valid] for a in arrays], names


def _shard_rows(table, counts):
    counts = np.asarray(counts).tolist()
    cols = [np.asarray(c.data) for c in table.columns]
    cap = cols[0].shape[0] // len(counts)
    return [sorted((tuple(_cell(x) for x in r) for r in
                    zip(*[c[s * cap: s * cap + n].tolist() for c in cols])), key=repr)
            for s, n in enumerate(counts)]


def _config(kw, monkeypatch):
    if kw.get("carry_payloads"):
        monkeypatch.setenv("DJ_JOIN_CARRY", "1")
        monkeypatch.setenv("DJT_JOIN_CARRY", "1")
    return dj_tpu.JoinConfig(over_decom_factor=2, bucket_factor=8.0, join_out_factor=64.0,
                             key_range=kw.get("key_range"))


def _jax_join(w, left, right, lon, ron, cfg):
    """dj_tpu's (out, counts, info) on w devices of the CPU mesh."""
    topo = jmake_topology(jax.devices()[:w])
    (l, lc), (r, rc) = (
        jshard(topo, dj_tpu.from_arrays(*[jnp.asarray(a) for a in arrays],
                                        dtypes=[dj_tpu.dtypes.by_name(n) for n in names]))
        for arrays, names in (left, right))
    return dj_tpu.distributed_inner_join(topo, l, lc, r, rc, lon, ron, cfg)


def _port_join(w, left, right, lon, ron, cfg):
    """The port's (out, counts, info) in a world of w CPU ranks."""
    topo = tj.make_topology(["cpu"] * w)
    (l, lc), (r, rc) = (
        tj.shard_table(topo, convert.table_from_numpy(arrays, names, device="cpu"))
        for arrays, names in (left, right))
    return tj.distributed_inner_join(topo, l, lc, r, rc, lon, ron, convert.join_config_from(cfg))


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("w", [1, 4])
def test_world_key_kind_matches_dj_tpu(w, name, monkeypatch):
    """A kind through both packages, shard for shard. The mixed kind
    pairs keys of two widths, which the port refuses at every world
    (its hash would send equal values to different ranks):
    ``tests/test_torch_key_widths.py`` holds dj_tpu's row loss."""
    left, right, lon, ron, _, kw = _kind(name)
    cfg = _config(kw, monkeypatch)
    if name == "mixed_int16_int64":
        with pytest.raises(ValueError, match=r"key pair 0 .* joins (int16 with int64|int64 with int16)"):
            _port_join(w, _valid(left), _valid(right), lon, ron, cfg)
        return
    jout, jcounts, jinfo = _jax_join(w, _valid(left), _valid(right), lon, ron, cfg)
    tout, tcounts, tinfo = _port_join(w, _valid(left), _valid(right), lon, ron, cfg)
    assert tcounts.tolist() == np.asarray(jcounts).tolist() and int(tcounts.sum()) > 0
    assert {k: v.tolist() for k, v in tinfo.items()} == {
        k: np.asarray(v).tolist() for k, v in jinfo.items()}
    assert not any(v.any() for v in tinfo.values())
    assert repr(_shard_rows(tout, tcounts)) == repr(_shard_rows(jout, jcounts))


@pytest.mark.parametrize("name", ["uint64_top_bit", "uint64_declared", "uint64_full_range"])
@pytest.mark.parametrize("w", [1, 4])
def test_world_uint64_keys_match_dj_tpu_int64_image(w, name, monkeypatch):
    left, right, lon, ron, _, kw = _kind(name)
    tleft, tright = _valid(left), _valid(right)
    jleft = _as_int64_keys(*tleft, lon)
    jright = _as_int64_keys(*tright, ron)
    jkw = dict(kw, key_range=tuple(v - 2**63 for v in kw["key_range"])) if kw else kw
    jout, jcounts, jinfo = _jax_join(w, jleft, jright, lon, ron, _config(jkw, monkeypatch))
    tout, tcounts, tinfo = _port_join(w, tleft, tright, lon, ron, _config(kw, monkeypatch))
    assert int(tcounts.sum()) == int(np.asarray(jcounts).sum()) > 0
    assert not any(v.any() for v in tinfo.values())
    assert not any(np.asarray(v).any() for v in jinfo.values())
    got = sorted(r for shard in _shard_rows(tout, tcounts) for r in shard)
    want = sorted((r[0] + 2**63,) + r[1:] for shard in _shard_rows(jout, jcounts) for r in shard)
    assert got == want
