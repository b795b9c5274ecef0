"""Bucketed all-to-all table shuffle: plan, exchange, compact.

Counterpart of ``dj_tpu/parallel/all_to_all.py``. Each partition is
padded into a bucket of static size
(``bucketize``), one ``Communicator.exchange`` moves every bucket of
the epoch, and a gather concatenates the received valid prefixes
(``compact``). ``shuffle_tables`` shuffles several tables through one
epoch, as a join batch's left and right tables do:

1. one batched size exchange: every table's per-peer row counts and
   every string column's per-peer byte counts form one [n, V] int32
   matrix that rides the 4-byte class of the data exchange;
2. one exchange for all data: per (width, table) the equal-width
   columns stack, as same-width signed integer views, into one
   [n, B, k] buffer (``ShufflePlan``), and fuse-capable communicators
   move each width class across the tables with one collective. A
   string column is two buffers, as in the reference: its int32 row
   sizes ride the 4-byte class, and its chars go as [n, char bucket]
   uint8 buffers (``default_char_bucket``), all of them in one more
   collective;
3. ``compact`` per received buffer into the table's output; a string
   column's offsets are rebuilt from its received sizes.

``compression`` (an options tree per table, ``compress.cascaded``) sends
a slot whose options are ``METHOD_CASCADED`` through the wire codec: its
buckets are compressed into [n, cap_words] int64 words
(``compressed_capacity_words`` of the raw bucket bytes and the slot's
wire_factor), which ride the same exchange, and are decompressed before
the compact. A string column's options come from its sizes child; its
chars never compress. A bucket whose stream does not fit is a
``bucket_overflow`` (the wire's capacity scales with bucket_rows), and
the table's stats add ``comp_raw_bytes``, ``comp_wire_bytes`` and
``comp_actual_bytes`` (float32, the reference's ratio report).

A char bucket too small for a peer's bytes is a ``bucket_overflow``, an
output char capacity too small an ``out_overflow``, as for rows.

``shuffle_tables_start`` issues steps 1 and 2 (bucketize, then
``Communicator.exchange_start``) and returns a handle whose ``wait()``
does step 3, so a pipeline can issue batch b+1's shuffle before it joins
batch b (dj_tpu/parallel/dist_join.py:278-305); ``shuffle_tables`` is
the two in a row.

A one-peer group shuffles by the self-copy of ``_single_peer_shuffle``
(dj_tpu/parallel/all_to_all.py:204-249), which compresses nothing.

``broadcast_table`` (dj_tpu/parallel/all_to_all.py:546-667) gives every
peer the whole table: all-gathers and a compact, no all-to-all. It is
the data movement of the broadcast tiers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..compress import cascaded as cz
from ..core.search import interval_of_arange
from ..core.table import Column, StringColumn, Table, gather_fill, sizes_to_offsets
from .communicator import Communicator, Pending, done

# Split-overflow stat keys: OVF_BUCKET is a send bucket that was too
# small (heals by bucket_factor growth), OVF_OUT an output capacity that
# was exceeded (heals by out_factor growth).
OVF_BUCKET = "bucket_overflow"
OVF_OUT = "out_overflow"

# The same-width signed integer dtype each column travels as (PyTorch's
# card build has no unsigned indexing or masked fills).
_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def default_char_bucket(char_capacity: int, bucket_rows: int, row_capacity: int) -> int:
    """Char-bucket bytes with the row buckets' slack ratio (bucket_rows
    / row_capacity), so the two buffers overflow at alike odds."""
    return max(1, -(-char_capacity * bucket_rows // max(1, row_capacity)))


def _gather_columns(cols, idx: torch.Tensor, fill: torch.Tensor) -> list:
    """``c[idx]`` (0 where ``fill``) for each 1-D column ``c``. The
    shuffle gathers column by column: on an H100 its bucketize and
    compact took 6.7 times as long when they gathered whole 16-byte rows
    of a [rows, 2] buffer (``chip_smoke.py`` phase 4d)."""
    return [gather_fill(c, idx, fill) for c in cols]


def _bucket_index(
    starts: torch.Tensor, counts: torch.Tensor, bucket_rows: int, rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """bucketize's [nparts, bucket_rows] source rows and fill mask."""
    j = torch.arange(bucket_rows, dtype=torch.int64, device=starts.device)
    idx = starts.to(torch.int64)[:, None] + j[None, :]
    valid = (j[None, :] < counts[:, None]) & (idx < rows)
    return torch.where(valid, idx, 0), ~valid


def bucketize(
    data: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor, bucket_rows: int
) -> torch.Tensor:
    """Gather partitions [starts[p], starts[p] + counts[p]) into padded
    buckets of shape [nparts, bucket_rows, ...]; rows past a partition's
    count are 0."""
    idx, fill = _bucket_index(starts, counts, bucket_rows, data.shape[0])
    cols = _gather_columns(data.reshape(data.shape[0], -1).unbind(1), idx, fill)
    return torch.stack(cols, dim=-1).reshape(idx.shape + data.shape[1:])


def _compact_index(
    recv_counts: torch.Tensor, n: int, bucket: int, out_capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """compact's [out_capacity] source rows in the flat [n * bucket]
    buckets, its fill mask and the total."""
    recv_offsets = sizes_to_offsets(recv_counts)
    total = recv_offsets[-1]
    k = torch.arange(out_capacity, dtype=torch.int64, device=recv_counts.device)
    p = interval_of_arange(recv_offsets, out_capacity, n).to(torch.int64)
    idx = p * bucket + k - recv_offsets[p]
    # The JAX package's fill index (n * bucket) is past the end: mask it.
    valid = (k < total) & (idx < n * bucket)
    return torch.where(valid, idx, 0), ~valid, total


def compact(
    buckets: torch.Tensor, recv_counts: torch.Tensor, out_capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate the valid prefix of each received bucket. Returns
    (data[out_capacity, ...], total): slots past the total are 0, and
    total is the true row count (it may exceed out_capacity)."""
    n, bucket = buckets.shape[0], buckets.shape[1]
    idx, fill, total = _compact_index(recv_counts, n, bucket, out_capacity)
    cols = _gather_columns(buckets.reshape(n * bucket, -1).unbind(1), idx, fill)
    return torch.stack(cols, dim=-1).reshape((out_capacity,) + buckets.shape[2:]), total


Slot = tuple[int, int]  # (table, column)


@dataclasses.dataclass(frozen=True)
class ShufflePlan:
    """Which row-aligned buffers ride which collective: one (element
    width, slots) group per width across every table of the epoch when
    fused, one per buffer otherwise (dj_tpu/parallel/all_to_all.py:
    127-195). A string column's slot is its int32 size vector, in the
    4-byte group; its chars are not row-aligned and travel apart. A slot
    whose options are ``METHOD_CASCADED`` (a string column's: its sizes
    child's) leaves the width groups for ``compressed``, with its
    options."""

    width_groups: tuple[tuple[int, tuple[Slot, ...]], ...]
    compressed: tuple[tuple[Slot, cz.ColumnCompressionOptions], ...] = ()

    @staticmethod
    def for_tables(tables: Sequence[Table], fuse: bool,
                   compression: Optional[Sequence] = None) -> "ShufflePlan":
        slots, compressed = [], []
        for t, table in enumerate(tables):
            tree = None if compression is None else compression[t]
            for i, col in enumerate(table.columns):
                is_str = isinstance(col, StringColumn)
                o = None if tree is None else tree[i]
                if is_str and o is not None:
                    o = o.children[0] if o.children else None
                if o is not None and o.method == cz.METHOD_CASCADED:
                    compressed.append(((t, i), o))
                else:
                    slots.append((4 if is_str else col.data.element_size(), (t, i)))
        if not fuse:
            return ShufflePlan(tuple((w, (s,)) for w, s in slots), tuple(compressed))
        groups: dict[int, list[Slot]] = {}
        for w, s in slots:
            groups.setdefault(w, []).append(s)
        return ShufflePlan(tuple((w, tuple(ss)) for w, ss in sorted(groups.items())),
                           tuple(compressed))


def _copy_prefix(data: torch.Tensor, start: int, count: int, length: int) -> torch.Tensor:
    """``data[start : start + count]`` at the front of ``length`` zeros
    (cut to ``length``)."""
    out = torch.zeros(length, dtype=data.dtype, device=data.device)
    part = data[start : start + min(count, length)]
    out[: part.shape[0]] = part
    return out


def _single_peer_shuffle(
    table: Table, part_starts: torch.Tensor, part_counts: torch.Tensor,
    out_capacity: int, char_caps: Callable[[int], tuple[int, int]],
) -> tuple[Table, torch.Tensor, torch.Tensor, dict]:
    """Copy rows [part_starts[0], +part_counts[0]) into a table of
    ``out_capacity`` rows, zero past the count; a string column's sizes
    and its bytes from the partition's first one, into ``char_caps(i)[1]``
    bytes. The start, the count and a string column's first byte are
    read back to the host to slice. When the partition is the whole
    table at its own capacity (one rank, one batch) the fixed-width
    columns are returned as they are: the copy would be the identity."""
    total = part_counts[0].to(torch.int32)
    overflow = total > out_capacity
    start, n = int(part_starts[0]), int(part_counts[0])
    count = min(n, out_capacity)
    identity = start == 0 and count == out_capacity == table.capacity
    cols = []
    for i, col in enumerate(table.columns):
        if isinstance(col, StringColumn):
            _, cout = char_caps(i)
            offsets = sizes_to_offsets(_copy_prefix(col.sizes(), start, count, out_capacity))
            nbytes = int(offsets[-1])
            chars = _copy_prefix(col.chars, int(col.offsets[start]), nbytes, cout)
            overflow = overflow | (offsets[-1] > cout)
            cols.append(StringColumn(offsets, chars, col.dtype))
        elif identity:
            cols.append(col)
        else:
            cols.append(Column(_copy_prefix(col.data, start, count, out_capacity), col.dtype))
    cols = tuple(cols)
    dev = table.device
    # No send buckets exist on one peer: every overflow is an output one.
    stats = {OVF_BUCKET: torch.tensor(False, device=dev), OVF_OUT: overflow}
    out_count = torch.tensor(count, dtype=torch.int32, device=dev)
    return Table(cols, out_count), total, overflow, stats


def shuffle_tables(
    comm: Communicator,
    tables: Sequence[Table],
    part_starts: Sequence[torch.Tensor],
    part_counts: Sequence[torch.Tensor],
    bucket_rows: Sequence[int],
    out_capacity: Sequence[int],
    char_bucket_bytes: Optional[Sequence[Optional[dict]]] = None,
    char_out_bytes: Optional[Sequence[Optional[dict]]] = None,
    compression: Optional[Sequence] = None,
) -> list[tuple[Table, torch.Tensor, torch.Tensor, dict]]:
    """Shuffle hash-partitioned tables through one epoch: partition p of
    every table goes to group peer p. Returns one (table,
    total_recv_rows, overflow, stats) per table; ``stats`` holds the
    split bits OVF_BUCKET (a send bucket, of rows or of chars, was too
    small) and OVF_OUT (an output capacity, of rows or of chars, was
    exceeded), ``overflow`` their OR. ``char_bucket_bytes[t]`` and
    ``char_out_bytes[t]`` map a string column of table t to its char
    bucket and output char capacity (default ``default_char_bucket`` and
    n buckets). ``compression[t]`` is table t's options tree or None
    (module docstring); a table with compressed slots also has the
    ``comp_*`` byte counters in its stats. Every rank of the group calls
    it with the same static sizes and options."""
    return shuffle_tables_start(
        comm, tables, part_starts, part_counts, bucket_rows, out_capacity,
        char_bucket_bytes, char_out_bytes, compression,
    ).wait()


def shuffle_tables_start(
    comm: Communicator,
    tables: Sequence[Table],
    part_starts: Sequence[torch.Tensor],
    part_counts: Sequence[torch.Tensor],
    bucket_rows: Sequence[int],
    out_capacity: Sequence[int],
    char_bucket_bytes: Optional[Sequence[Optional[dict]]] = None,
    char_out_bytes: Optional[Sequence[Optional[dict]]] = None,
    compression: Optional[Sequence] = None,
) -> Pending:
    """Issue ``shuffle_tables``: bucketize and start the exchange. The
    handle's ``wait()`` waits for the exchange, compacts and returns
    what ``shuffle_tables`` returns. Every rank issues its shuffles in
    the same order."""
    nt = len(tables)
    n = comm.size
    for seq, name in (
        (part_starts, "part_starts"), (part_counts, "part_counts"),
        (bucket_rows, "bucket_rows"), (out_capacity, "out_capacity"),
    ):
        if len(seq) != nt:
            raise ValueError(f"{name}: expected {nt} entries")
    for t in range(nt):
        if part_starts[t].shape != (n,) or part_counts[t].shape != (n,):
            raise ValueError(f"table {t}: part_starts/part_counts must have shape ({n},)")
    char_bucket_bytes = char_bucket_bytes or [None] * nt
    char_out_bytes = char_out_bytes or [None] * nt

    def char_caps(t: int, i: int) -> tuple[int, int]:
        col = tables[t].columns[i]
        bucket = (char_bucket_bytes[t] or {}).get(i) or default_char_bucket(
            col.chars.shape[0], bucket_rows[t], tables[t].capacity)
        return bucket, (char_out_bytes[t] or {}).get(i) or n * bucket

    if n == 1:
        return done([
            _single_peer_shuffle(tables[t], part_starts[t], part_counts[t], out_capacity[t],
                                 lambda i, t=t: char_caps(t, i))
            for t in range(nt)
        ])

    comm.phase("a2a_bucketize")
    plan = ShufflePlan.for_tables(tables, comm.fuse_columns, compression)
    send_ovf = [(part_counts[t] > bucket_rows[t]).any() for t in range(nt)]
    sent = [part_counts[t].clamp_max(bucket_rows[t]).to(torch.int32) for t in range(nt)]
    string_cols = [(t, i) for t in range(nt) for i, c in enumerate(tables[t].columns)
                   if isinstance(c, StringColumn)]
    char_meta = {}
    size_vecs = list(sent)
    for t, i in string_cols:
        offsets = tables[t].columns[i].offsets
        cbucket, cout = char_caps(t, i)
        byte_starts = offsets[part_starts[t]]
        byte_counts = offsets[part_starts[t] + part_counts[t]] - byte_starts
        sent_bytes = byte_counts.clamp_max(cbucket).to(torch.int32)
        char_meta[(t, i)] = (byte_starts, sent_bytes, (byte_counts > cbucket).any(), cbucket,
                             cout)
        size_vecs.append(sent_bytes)
    buffers = [torch.stack(size_vecs, dim=1)]  # the [n, V] size matrix
    send_index = [
        _bucket_index(part_starts[t], sent[t], bucket_rows[t], tables[t].capacity)
        for t in range(nt)
    ]
    metas: list[tuple[int, tuple[Slot, ...]]] = []
    for width, slots in plan.width_groups:
        by_table: dict[int, list[Slot]] = {}
        for s in slots:
            by_table.setdefault(s[0], []).append(s)
        for t, tslots in by_table.items():
            cols = [_slot_data(tables[t].columns[i]).view(_INT_OF_SIZE[width]) for _, i in tslots]
            buffers.append(torch.stack(_gather_columns(cols, *send_index[t]), dim=-1))  # [n, B, k]
            metas.append((t, tuple(tslots)))
    comp_metas = []
    for (t, i), copts in plan.compressed:
        raw = _slot_data(tables[t].columns[i])
        itemsize = raw.element_size()
        cap_words = cz.compressed_capacity_words(bucket_rows[t] * itemsize, copts.wire_factor)
        words, nwords, wovf = cz.compress_buckets(
            _gather_columns([raw], *send_index[t])[0], itemsize, copts.cascaded, cap_words,
            sent[t])
        buffers.append(words)  # [n, cap_words] int64
        comp_metas.append(((t, i), copts, raw.dtype, nwords, cap_words, wovf))
    del send_index
    for t, i in string_cols:
        byte_starts, sent_bytes, _, cbucket, _ = char_meta[(t, i)]
        buffers.append(bucketize(tables[t].columns[i].chars, byte_starts, sent_bytes, cbucket))

    comm.phase("a2a_exchange")
    pending = comm.exchange_start(buffers)
    del buffers
    schema = [[(_slot_data(c).dtype, c.dtype) for c in tb.columns] for tb in tables]
    bucket_rows, out_capacity = list(bucket_rows), list(out_capacity)

    def finish():
        received = pending.wait()
        comm.phase("a2a_compact")
        recv_mat = received[0]
        recv_index = [_compact_index(recv_mat[:, t], n, bucket_rows[t], out_capacity[t])
                      for t in range(nt)]
        totals = [total for _, _, total in recv_index]
        counts = [totals[t].clamp_max(out_capacity[t]).to(torch.int32) for t in range(nt)]
        bucket_ovfs = list(send_ovf)
        out_ovfs = [totals[t] > out_capacity[t] for t in range(nt)]
        out_cols: list[list] = [[None] * len(schema[t]) for t in range(nt)]
        for buf, (t, tslots) in zip(received[1:], metas):
            idx, fill, _ = recv_index[t]
            data = _gather_columns(buf.reshape(n * bucket_rows[t], -1).unbind(1), idx, fill)
            for d, (_, i) in zip(data, tslots):
                tdtype, dtype = schema[t][i]
                out_cols[t][i] = Column(d.view(tdtype), dtype)
        stats: list[dict] = [{} for _ in range(nt)]
        received_comp = received[1 + len(metas) : 1 + len(metas) + len(comp_metas)]
        for buf, ((t, i), copts, physical, nwords, cap_words, wovf) in zip(received_comp,
                                                                           comp_metas):
            # Decompress, then compact (the reference's compressed
            # all-to-all, all_to_all_comm.cpp:358-465).
            dec = cz.decompress_buckets(buf, physical.itemsize, copts.cascaded,
                                        bucket_rows[t], physical)
            idx, fill, _ = recv_index[t]
            out_cols[t][i] = Column(_gather_columns([dec.reshape(-1)], idx, fill)[0],
                                    schema[t][i][1])
            # The wire's capacity scales with the bucket: bucket_factor
            # heals its overflow.
            bucket_ovfs[t] = bucket_ovfs[t] | wovf.any()
            itemsize = physical.itemsize
            for key, value in (
                ("comp_raw_bytes", sent[t].sum().to(torch.float32) * itemsize),
                ("comp_wire_bytes", torch.tensor(n * cap_words * 8, dtype=torch.float32,
                                                 device=buf.device)),
                ("comp_actual_bytes", nwords.sum().to(torch.float32) * 8),
            ):
                stats[t][key] = stats[t].get(key, torch.zeros((), dtype=torch.float32,
                                                               device=buf.device)) + value
        del recv_index
        # Chars: compacted by the received byte counts; offsets rebuilt
        # from the received sizes of the valid rows.
        first_chars = 1 + len(metas) + len(comp_metas)
        for j, (buf, (t, i)) in enumerate(zip(received[first_chars:], string_cols)):
            _, _, covf, _, cout = char_meta[(t, i)]
            chars, btotal = compact(buf, recv_mat[:, nt + j], cout)
            sizes = out_cols[t][i].data
            sizes = sizes.masked_fill_(torch.arange(sizes.shape[0], device=sizes.device)
                                       >= counts[t], 0)
            bucket_ovfs[t] = bucket_ovfs[t] | covf
            out_ovfs[t] = out_ovfs[t] | (btotal > cout)
            out_cols[t][i] = StringColumn(sizes_to_offsets(sizes), chars, schema[t][i][1])
        results = []
        for t in range(nt):
            stats[t].update({OVF_BUCKET: bucket_ovfs[t], OVF_OUT: out_ovfs[t]})
            results.append((Table(tuple(out_cols[t]), counts[t]), totals[t],
                            bucket_ovfs[t] | out_ovfs[t], stats[t]))
        return results

    return Pending(finish)


def _slot_data(col) -> torch.Tensor:
    """The row-aligned buffer of a column: its data, or a string
    column's int32 row sizes."""
    return col.sizes() if isinstance(col, StringColumn) else col.data


def shuffle_table(
    comm: Communicator,
    table: Table,
    part_starts: torch.Tensor,
    part_counts: torch.Tensor,
    bucket_rows: int,
    out_capacity: int,
    compression=None,
) -> tuple[Table, torch.Tensor, torch.Tensor, dict]:
    """Shuffle one hash-partitioned table: the one-table view of
    ``shuffle_tables``, with the same (table, total_recv_rows, overflow,
    stats) result; ``compression`` is the table's options tree."""
    return shuffle_table_start(
        comm, table, part_starts, part_counts, bucket_rows, out_capacity, compression
    ).wait()


def shuffle_table_start(
    comm: Communicator,
    table: Table,
    part_starts: torch.Tensor,
    part_counts: torch.Tensor,
    bucket_rows: int,
    out_capacity: int,
    compression=None,
) -> Pending:
    """Issue ``shuffle_table``; ``wait()`` gives its result."""
    pending = shuffle_tables_start(
        comm, [table], [part_starts], [part_counts], [bucket_rows], [out_capacity],
        compression=[compression],
    )
    return Pending(lambda: pending.wait()[0])


def broadcast_table(
    comm: Communicator,
    table: Table,
    out_capacity: int,
    char_out_bytes: Optional[dict] = None,
) -> tuple[Table, torch.Tensor, torch.Tensor, dict]:
    """Give every group peer the whole row-sharded table: the broadcast
    tiers' data movement, with no partition and no all-to-all.

    One all-gather of the batched size vector (this peer's row count,
    then the char bytes of each string column), one all-gather of each
    fixed-width column's buffer and two of each string column's (its
    int32 row sizes and its chars); then ``compact`` concatenates the
    peers' valid prefixes into ``out_capacity`` rows, a string column's
    offsets rebuilt from its sizes by a scan. ``char_out_bytes`` maps a
    string column to its output char capacity (default n times its
    shard's, which cannot overflow). Returns the ``shuffle_table``
    contract (table, total_rows, overflow, stats); no send buckets
    exist, so OVF_BUCKET is False. A one-peer group is
    ``_single_peer_shuffle``'s self-copy."""
    n = comm.size
    count = table.count()
    char_out_bytes = char_out_bytes or {}

    def char_out(i: int) -> int:
        override = char_out_bytes.get(i)
        return override if override is not None else n * table.columns[i].chars.shape[0]

    if n == 1:
        zero = torch.zeros(1, dtype=torch.int32, device=table.device)
        return _single_peer_shuffle(table, zero, count.reshape(1).to(torch.int32), out_capacity,
                                    lambda i: (table.columns[i].chars.shape[0], char_out(i)))
    string_cols = [i for i, c in enumerate(table.columns) if isinstance(c, StringColumn)]
    size_vec = torch.stack([count.to(torch.int32)] + [
        table.columns[i].offsets[count].to(torch.int32) for i in string_cols])
    comm.phase("bc_gather")
    counts_g = comm.all_gather(size_vec)  # [n, 1 + string columns]
    sent = [size_vec]  # each all-gather's send buffer: one epoch's launches
    gathered = []  # (kind, column, [n, ...] buffer)
    for i, col in enumerate(table.columns):
        if isinstance(col, StringColumn):
            sizes = col.sizes()
            gathered.append(("sizes", i, comm.all_gather(sizes)))
            gathered.append(("chars", i, comm.all_gather(col.chars)))
            sent += [sizes, col.chars]
        else:
            gathered.append(("col", i, comm.all_gather(col.data)))
            sent.append(col.data)
    comm.count_epoch(len(sent), sent)
    del sent
    comm.phase("bc_compact")
    recv_rows = counts_g[:, 0]
    total = sizes_to_offsets(recv_rows)[-1]
    out_count = total.clamp_max(out_capacity).to(torch.int32)
    overflow = total > out_capacity
    out_cols: list = [None] * table.num_columns
    recv_sizes = {}
    for kind, i, buf in gathered:
        if kind == "col":
            out_cols[i] = Column(compact(buf, recv_rows, out_capacity)[0], table.columns[i].dtype)
        elif kind == "sizes":
            recv_sizes[i] = compact(buf, recv_rows, out_capacity)[0]
    for kind, i, buf in gathered:
        if kind != "chars":
            continue
        cout = char_out(i)
        chars, btotal = compact(buf, counts_g[:, 1 + string_cols.index(i)], cout)
        sizes = recv_sizes[i].masked_fill_(
            torch.arange(out_capacity, device=buf.device) >= out_count, 0)
        overflow = overflow | (btotal > cout)
        out_cols[i] = StringColumn(sizes_to_offsets(sizes), chars, table.columns[i].dtype)
    del gathered
    stats = {OVF_BUCKET: torch.tensor(False, device=table.device), OVF_OUT: overflow}
    return Table(tuple(out_cols), out_count), total, overflow, stats
