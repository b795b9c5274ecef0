"""dj_tpu_torch's parquet reader against dj_tpu's, file for file.

The repo holds no parquet file, so each case writes its own with
pyarrow into ``tmp_path`` and reads it through both packages'
``data/io.py``: every type of ``_ARROW_FIXED``, timestamps in s, ms, us
and ns, durations, date32, string, large_string and binary, nulls,
several row groups and a ``columns=`` subset. Compared are the dtype
names, the values (offsets and chars for strings), ``drop_nulls`` and
``table_data_nbytes``; an unsupported type raises ``TypeError`` in both,
and the reader without pyarrow raises dj_tpu's ``ImportError`` text.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest
import torch

from dj_tpu.core.table import StringColumn as JStringColumn
from dj_tpu.data import io as jio
from dj_tpu_torch.core.table import StringColumn
from dj_tpu_torch.data import io as tio

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 300


def _fixed_arrays(rng):
    out = {}
    for name in ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64"):
        info = np.iinfo(name)
        out[name] = pa.array(rng.integers(info.min, info.max, N, dtype=name, endpoint=True))
    out["float32"] = pa.array(rng.standard_normal(N).astype(np.float32))
    out["float64"] = pa.array(rng.standard_normal(N))
    return out


def _temporal_arrays(rng):
    ticks = rng.integers(-(2**40), 2**40, N)
    out = {f"ts_{u}": pa.array(ticks, pa.timestamp(u)) for u in ("s", "ms", "us", "ns")}
    out.update({f"dur_{u}": pa.array(ticks, pa.duration(u)) for u in ("s", "ms", "us", "ns")})
    out["ts_tz"] = pa.array(ticks, pa.timestamp("ms", tz="UTC"))
    out["date32"] = pa.array(rng.integers(-20000, 20000, N).astype(np.int32), pa.date32())
    return out


def _string_arrays(rng):
    words = [bytes(rng.integers(97, 123, int(k)).astype(np.uint8)) for k in rng.integers(0, 12, N)]
    text = [w.decode() for w in words]
    return {"string": pa.array(text, pa.string()),
            "large_string": pa.array(text, pa.large_string()),
            "binary": pa.array(words, pa.binary())}


def _with_nulls(arr, rng, share=0.2):
    mask = pa.array(rng.random(len(arr)) < share)
    return pc.if_else(mask, pa.nulls(len(arr), arr.type), arr)


def _write(tmp_path, arrays: dict, row_group_size=None, name="t.parquet") -> str:
    path = str(tmp_path / name)
    pq.write_table(pa.table(arrays), path, row_group_size=row_group_size)
    return path


def _view(t) -> list:
    """Each column as (dtype name, values) or (dtype name, offsets, chars)."""
    out = []
    for c in t.columns:
        if isinstance(c, (StringColumn, JStringColumn)):
            out.append((c.dtype.name, np.asarray(c.offsets).tolist(),
                        np.asarray(c.chars).tolist()))
        else:
            vals = np.asarray(c.data)
            out.append((c.dtype.name, str(vals.dtype), vals.tobytes()))
    return out


class _Cols:
    """A stand-in table of one column, for ``_view``."""

    def __init__(self, col):
        self.columns = [col]


def _same(tj, tt):
    assert _view(tj) == _view(tt)
    for c in tt.columns:
        tensors = [c.offsets, c.chars] if isinstance(c, StringColumn) else [c.data]
        assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in tensors)
    assert jio.table_data_nbytes(tj) == tio.table_data_nbytes(tt)


@pytest.mark.parametrize("family", ["fixed", "temporal", "strings"])
@pytest.mark.parametrize("nulls", [False, True])
def test_read_parquet_matches_dj_tpu(tmp_path, family, nulls):
    rng = np.random.default_rng({"fixed": 1, "temporal": 2, "strings": 3}[family])
    arrays = {"fixed": _fixed_arrays, "temporal": _temporal_arrays,
              "strings": _string_arrays}[family](rng)
    if nulls:
        arrays = {k: _with_nulls(a, rng) for k, a in arrays.items()}
    path = _write(tmp_path, arrays, row_group_size=64)
    assert pq.ParquetFile(path).num_row_groups > 1
    _same(jio.read_parquet(path), tio.read_parquet(path))
    # Parquet stores timestamp[s] as ms: every unit through from_arrow.
    table = pa.table(arrays)
    _same(jio.from_arrow(table), tio.from_arrow(table))
    names = [c.dtype.name for c in tio.from_arrow(table).columns]
    if family == "fixed":
        assert names == list(arrays)
    if family == "temporal":
        assert names == [f"timestamp_{u}" for u in ("s", "ms", "us", "ns")] + [
            f"duration_{u}" for u in ("s", "ms", "us", "ns")] + ["timestamp_ms", "int32"]
    # The arrow table, filtered before ingest.
    at_j = jio.read_parquet_arrow(path)
    at_t = tio.read_parquet_arrow(path)
    assert at_j.equals(at_t)
    subset = list(range(at_t.num_columns))
    dj, dt_ = jio.drop_nulls(at_j, subset), tio.drop_nulls(at_t, subset)
    assert dj.equals(dt_)
    if nulls:
        assert dt_.num_rows < at_t.num_rows
    _same(jio.from_arrow(dj), tio.from_arrow(dt_))
    # One column at a time, chunked and not.
    for i in range(at_t.num_columns):
        col = at_t.column(i)
        assert col.num_chunks > 1
        got = _view(_Cols(tio.column_from_arrow(col)))
        assert got == _view(_Cols(jio.column_from_arrow(col)))
        assert got == _view(_Cols(tio.column_from_arrow(col.combine_chunks())))


def test_columns_subset_and_nulls_in_key_only(tmp_path):
    rng = np.random.default_rng(4)
    arrays = {**_fixed_arrays(rng), **_string_arrays(rng)}
    arrays["int64"] = _with_nulls(arrays["int64"], rng, 0.3)
    path = _write(tmp_path, arrays, row_group_size=100)
    cols = ["string", "int64", "float32"]
    tj, tt = jio.read_parquet(path, columns=cols), tio.read_parquet(path, columns=cols)
    _same(tj, tt)
    assert [c.dtype.name for c in tt.columns] == ["string", "int64", "float32"]
    aj = jio.read_parquet_arrow(path, columns=cols)
    at = tio.read_parquet_arrow(path, columns=cols)
    kept_j, kept_t = jio.drop_nulls(aj, [1]), tio.drop_nulls(at, [1])
    assert kept_t.num_rows == N - arrays["int64"].null_count
    _same(jio.from_arrow(kept_j), tio.from_arrow(kept_t))
    # An empty subset keeps every row.
    assert tio.drop_nulls(at, []).num_rows == N


def test_all_empty_strings_and_empty_table(tmp_path):
    arrays = {"s": pa.array([""] * 5), "b": pa.array([None] * 5, pa.binary()),
              "k": pa.array(np.arange(5, dtype=np.int64))}
    path = _write(tmp_path, arrays)
    _same(jio.read_parquet(path), tio.read_parquet(path))
    empty = pa.table({"k": pa.array([], pa.int64()), "s": pa.array([], pa.string())})
    _same(jio.from_arrow(empty), tio.from_arrow(empty))


@pytest.mark.parametrize("arr", [
    pa.array([True, False]),
    pa.array([1.5, 2.5], pa.float16()),
    pa.array([[1], [2, 3]]),
    pa.array([1, 2], pa.decimal128(10, 2)),
    pa.array([1000, 2000], pa.time64("us")),
    pa.array([1, 2], pa.date64()),
], ids=["bool", "float16", "list", "decimal", "time64", "date64"])
def test_unsupported_type_raises_type_error(arr):
    with pytest.raises(TypeError) as ej:
        jio.column_from_arrow(arr)
    with pytest.raises(TypeError) as et:
        tio.column_from_arrow(arr)
    assert str(ej.value) == str(et.value)


def test_reader_without_pyarrow_raises_dj_tpus_text(tmp_path):
    path = _write(tmp_path, {"k": pa.array(np.arange(3, dtype=np.int64))})
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from dj_tpu_torch.data import io\n"
        "try:\n"
        f"    io.read_parquet({path!r})\n"
        "except ImportError as e:\n"
        "    print('IMPORT_ERROR:' + str(e))\n"
    )
    r = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    text = r.stdout.strip().removeprefix("IMPORT_ERROR:")
    assert r.stdout.startswith("IMPORT_ERROR:")
    assert text == ("parquet/arrow IO requires pyarrow; install it or use the "
                    "synthetic generators in dj_tpu.data.generator")
    with pytest.raises(ImportError) as ej:
        sys.modules["pyarrow"], saved = None, sys.modules["pyarrow"]
        try:
            jio._arrow()
        finally:
            sys.modules["pyarrow"] = saved
    assert str(ej.value) == text


def test_read_parquet_shards_onto_a_topology(tmp_path):
    """The host table goes through ``shard_table`` as any other: a world
    of 2 on CPU ranks gets every row once."""
    import dj_tpu_torch as tj

    rng = np.random.default_rng(5)
    keys = rng.integers(0, 100, 64).astype(np.int64)
    path = _write(tmp_path, {"k": pa.array(keys), "s": pa.array([str(k) for k in keys])})
    topo = tj.make_topology(["cpu"] * 2)
    t, counts = tj.shard_table(topo, tio.read_parquet(path))
    got = []
    cap = t.columns[0].size // 2
    for r, n in enumerate(counts.tolist()):
        got += t.columns[0].data[r * cap: r * cap + n].tolist()
    assert sorted(got) == sorted(keys.tolist())
