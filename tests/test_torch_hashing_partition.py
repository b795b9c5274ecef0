"""dj_tpu_torch hashing and hash_partition vs dj_tpu, bit for bit.

The same numpy inputs (made from a seed) go through both packages on the
CPU; hashes, partition offsets and every reordered row must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_tpu.core import dtypes as jdt
from dj_tpu.core.table import Column as JColumn, Table as JTable
from dj_tpu.ops import hashing as jhash
from dj_tpu.ops import partition as jpart
from dj_tpu_torch import convert
from dj_tpu_torch.ops import hashing as thash
from dj_tpu_torch.ops import partition as tpart


def _values(dtype, n, rng):
    d = np.dtype(dtype)
    if np.issubdtype(d, np.integer):
        info = np.iinfo(d)
        x = rng.integers(info.min, info.max, n, endpoint=True, dtype=d)
        x[:4] = [info.min, info.max, 0, -1 if info.min < 0 else 1]
        return x
    x = rng.standard_normal(n).astype(d) * 1e6
    x[:3] = [-0.0, 0.0, np.inf]
    return x


@pytest.mark.parametrize("seed", [0, 12345678, 0xFFFFFFFF])
@pytest.mark.parametrize(
    "dtype",
    [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32,
     np.float32, np.float64],
)
def test_murmur3_bit_exact(dtype, seed):
    x = _values(dtype, 2000, np.random.default_rng(3))
    want = np.asarray(jhash.murmur3_32(jnp.asarray(x), seed)).astype(np.int64)
    got = thash.murmur3_32(torch.from_numpy(x), seed).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hash_function", [thash.HASH_MURMUR3, thash.HASH_IDENTITY])
def test_hash_columns_bit_exact(hash_function):
    rng = np.random.default_rng(4)
    a = _values(np.int64, 1000, rng)
    b = _values(np.int32, 1000, rng)
    cols = [a] if hash_function == thash.HASH_IDENTITY else [a, b]
    jcols = [JColumn(jnp.asarray(c), jdt.from_jnp(c.dtype)) for c in cols]
    want = np.asarray(jhash.hash_columns(jcols, 77, hash_function)).astype(np.int64)
    tt = convert.table_from_numpy(cols, [c.dtype.name for c in cols], device="cpu")
    got = thash.hash_columns(tt.columns, 77, hash_function).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_identity_hash_of_floats_is_the_value(dtype):
    """The identity hash of a float column is its value converted to
    uint32 (dj_tpu's astype), truncated toward zero, not its bits. Only
    values in [0, 2^31) are tested: XLA's float-to-uint32 convert of a
    negative value or one past 2^32 is not a contract to copy."""
    rng = np.random.default_rng(6)
    x = (rng.random(1000) * 2.0**31).astype(dtype)
    x[:6] = [0.0, -0.0, 0.5, 3.0, 7.5, 1e6]
    x = np.minimum(x, np.nextafter(dtype(2.0**31), dtype(0)))
    jcol = [JColumn(jnp.asarray(x), jdt.from_jnp(x.dtype))]
    want = np.asarray(jhash.hash_columns(jcol, 0, jhash.HASH_IDENTITY)).astype(np.int64)
    tt = convert.table_from_numpy([x], [x.dtype.name], device="cpu")
    got = thash.hash_columns(tt.columns, 0, thash.HASH_IDENTITY).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:6], [0, 0, 0, 3, 7, 1_000_000])


@pytest.mark.parametrize("npartitions", [1, 4, 7])
@pytest.mark.parametrize("valid", [1000, 731, 0])
def test_hash_partition_matches(npartitions, valid):
    rng = np.random.default_rng(npartitions * 1000 + valid)
    keys = rng.integers(-(2**62), 2**62, 1000)
    pay = np.arange(1000, dtype=np.int64) + 5
    small = rng.integers(-100, 100, 1000).astype(np.int32)
    arrays = [keys, pay, small]
    jt = JTable(
        tuple(JColumn(jnp.asarray(a), jdt.from_jnp(a.dtype)) for a in arrays),
        jnp.int32(valid),
    )
    jout, joff = jpart.hash_partition(jt, [0, 2], npartitions, seed=12345678)
    tt = convert.table_from_numpy(arrays, ["int64", "int64", "int32"], valid, device="cpu")
    tout, toff = tpart.hash_partition(tt, [0, 2], npartitions, seed=12345678)
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))
    assert int(tout.count()) == valid
    for jc, tc in zip(jout.columns, tout.columns):
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))


def test_partition_ids_padding_rows():
    tt = convert.table_from_numpy([np.arange(10, dtype=np.int64)], ["int64"], 6, device="cpu")
    pid = tpart.partition_ids(tt, [0], 3)
    assert (pid[6:] == 3).all() and (pid[:6] < 3).all()
    counts = tpart.partition_counts_from_ids(pid, 3)
    assert int(counts.sum()) == 6
