"""The plain reference and the comparison that decides ``correct``.

A straightforward inner join in plain PyTorch: the build keys sorted
once, each probe key's run of equal build keys found by two binary
searches, the runs expanded. It imports nothing of the program and
takes nothing the program made: the benchmark's generators hand it the
same inputs they hand the program, and it reads the program's answers
only to judge them.

Answers are compared as multisets of rows: both sides are put in one
canonical order, and a row counts as wrong when any of its values or
bytes differs (a missing or extra row counts once). Every comparison is
exact: its limit is 0.

The controls stand in for the program to show that the comparison
fails a join that breaks a guarantee of the configuration:
``hash32_keys`` joins on 32 bits of a hash of the 64-bit keys, unverified
(the width below the configuration's int64 keys), and
``truncate_strings`` carries each string payload in a fixed 8-byte field
(a string packed into one 64-bit word).
"""

from __future__ import annotations

import torch

STRING_BLOCK_ROWS = 8_000_000  # rows a block of the string comparison holds
CONTROL_STRING_BYTES = 8


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 bits (wrapping arithmetic, the
    right shifts made logical by masks)."""
    x = x ^ ((x >> 30) & ((1 << 34) - 1))
    x = x * -4658895280553007687  # 0xBF58476D1CE4E5B9 as int64
    x = x ^ ((x >> 27) & ((1 << 37) - 1))
    x = x * -7723592293110705685  # 0x94D049BB133111EB as int64
    return x ^ ((x >> 31) & ((1 << 33) - 1))


def hash32(keys: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of a 64-bit mix of each key: the control's key."""
    return _mix64(keys) & 0xFFFFFFFF


def _key_ids(left_keys, right_keys) -> tuple:
    """One int64 key a row for each side: a single key column as it is,
    several columns as the rank of each row's tuple among both sides'
    distinct tuples (a plain lexicographic sort), so that equal tuples
    get equal ids."""
    if isinstance(left_keys, torch.Tensor):
        return left_keys, right_keys
    if len(left_keys) == 1:
        return left_keys[0], right_keys[0]
    both = torch.stack([torch.cat([a, b]) for a, b in zip(left_keys, right_keys)], dim=1)
    ids = torch.unique(both, dim=0, return_inverse=True)[1]
    n = left_keys[0].shape[0]
    return ids[:n], ids[n:]


def match_pairs(left_keys, right_keys) -> tuple:
    """(left row, right row) of every pair of equal keys, int64. A side's
    keys are one tensor or a list of key columns, matched together."""
    left_keys, right_keys = _key_ids(left_keys, right_keys)
    dev = left_keys.device
    order = torch.argsort(right_keys)
    sorted_r = right_keys[order]
    lo = torch.searchsorted(sorted_r, left_keys)
    cnt = torch.searchsorted(sorted_r, left_keys, right=True) - lo
    total = int(cnt.sum())
    li = torch.repeat_interleave(torch.arange(left_keys.shape[0], device=dev), cnt,
                                 output_size=total)
    start = torch.cumsum(cnt, 0) - cnt
    ri = order[lo[li] + torch.arange(total, device=dev) - start[li]]
    return li, ri


def join_rows(left_keys, left_payload, right_keys, right_payload, key_map=None) -> list:
    """The int64 join's rows [key, left payload, right payload]: the
    program's result columns (the left table's, then the right's without
    its key). ``key_map`` is the control's hook: keys are matched through
    it."""
    if key_map is None:
        li, ri = match_pairs(left_keys, right_keys)
    else:
        li, ri = match_pairs(key_map(left_keys), key_map(right_keys))
    return [left_keys[li], left_payload[li], right_payload[ri]]


def canonical_order(cols: list) -> torch.Tensor:
    """The permutation that sorts int64 rows by column 1, then column 2
    and each later one, then column 0 (a multiset's canonical order)."""
    order = torch.argsort(cols[0], stable=True)
    for c in reversed(cols[1:]):
        order = order[torch.argsort(c[order], stable=True)]
    return order


def rows_wrong_int(got: list, want: list) -> int:
    """Rows of ``got`` that differ from ``want`` as multisets of int64
    rows: positions of the canonical orders where any column differs,
    plus the difference in row counts."""
    n, m = got[0].shape[0], want[0].shape[0]
    k = min(n, m)
    og, ow = canonical_order(got), canonical_order(want)
    bad = torch.zeros(k, dtype=torch.bool, device=got[0].device)
    for g, w in zip(got, want):
        bad |= g[og[:k]] != w[ow[:k]].to(g.device)
    return int(bad.sum()) + abs(n - m)


def string_rows_bad(got: tuple, want: tuple) -> torch.Tensor:
    """bool[n]: which rows' strings differ, given two string views
    (offsets, chars, rows) of n rows each: row i of a view is the string
    at ``rows[i]``. Compared in blocks of rows: a row is wrong when its
    size or any byte differs."""
    g_off, g_chars, g_rows = got
    w_off, w_chars, w_rows = want
    dev = g_off.device
    n = g_rows.shape[0]
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    for a in range(0, n, STRING_BLOCK_ROWS):
        gr = g_rows[a:a + STRING_BLOCK_ROWS]
        wr = w_rows[a:a + STRING_BLOCK_ROWS].to(dev)
        g_start = g_off[gr].to(torch.int64)
        w_start = w_off.to(dev)[wr].to(torch.int64)
        g_size = g_off[gr + 1].to(torch.int64) - g_start
        w_size = w_off.to(dev)[wr + 1].to(torch.int64) - w_start
        same = g_size == w_size
        size = torch.where(same, g_size, 0)
        nbytes = int(size.sum())
        row = torch.repeat_interleave(torch.arange(gr.shape[0], device=dev), size,
                                      output_size=nbytes)
        pos = torch.arange(nbytes, device=dev) - (torch.cumsum(size, 0) - size)[row]
        differ = g_chars[g_start[row] + pos] != w_chars.to(dev)[w_start[row] + pos]
        bad_row = torch.zeros(gr.shape[0], dtype=torch.int64, device=dev)
        bad_row.index_add_(0, row, differ.to(torch.int64))
        bad[a:a + STRING_BLOCK_ROWS] = (bad_row > 0) | ~same
    return bad


def keyed_string_rows_wrong(got_keys, got_strings: tuple, want_keys, want_strings: tuple) -> int:
    """Rows (key, string) of ``got`` that differ from ``want`` as
    multisets, where every string of one key is the same in ``want``
    (the key's order owns one string): both sorted by key, then keys and
    strings compared row by row, plus the difference in row counts."""
    n, m = got_keys.shape[0], want_keys.shape[0]
    k = min(n, m)
    og = torch.argsort(got_keys, stable=True)[:k]
    ow = torch.argsort(want_keys, stable=True)[:k]
    key_bad = got_keys[og] != want_keys[ow].to(got_keys.device)
    g_off, g_chars, g_rows = got_strings
    w_off, w_chars, w_rows = want_strings
    key_bad |= string_rows_bad((g_off, g_chars, g_rows[og]), (w_off, w_chars, w_rows[ow]))
    return int(key_bad.sum()) + abs(n - m)


def truncate_strings(offsets: torch.Tensor, chars: torch.Tensor, rows: torch.Tensor,
                     width: int = CONTROL_STRING_BYTES) -> tuple:
    """The control's strings: row i is the string at ``rows[i]`` cut to
    ``width`` bytes; returns (offsets, chars) of the new column."""
    start = offsets[rows].to(torch.int64)
    size = torch.clamp_max(offsets[rows + 1].to(torch.int64) - start, width)
    out_off = torch.zeros(rows.shape[0] + 1, dtype=torch.int64, device=offsets.device)
    torch.cumsum(size, 0, out=out_off[1:])
    nbytes = int(out_off[-1])
    row = torch.repeat_interleave(torch.arange(rows.shape[0], device=offsets.device), size,
                                  output_size=nbytes)
    pos = torch.arange(nbytes, device=offsets.device) - out_off[row]
    return out_off.to(torch.int32), chars[start[row] + pos]
