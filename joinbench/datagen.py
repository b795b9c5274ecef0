"""The benchmark's own generators, plain PyTorch on the device.

``build_probe`` copies ``generate_build_probe_tables`` of
``dj_tpu_torch/data/generator.py`` (the reference's generator: unique
build keys and their complement are the two halves of one random
permutation of [0, rand_max]; a probe key hits a build key with
probability ``selectivity`` and draws from the complement otherwise,
so the exact match count is the number of hits). ``world_build_probe``
gives rank r of a world its share of one such draw over the whole
world, so probe rows match build rows on every rank. ``tpch_split``
draws one split of TPC-H's orders and lineitem after ``make_split`` of
``dj_tpu_torch/data/tpch.py`` (shuffled unique orderkeys, a uniform
``O_ORDERPRIORITY`` of TPC-H's five, lineitems shuffled), in torch on
the device instead of numpy on the host, and with TPC-H's own laws
where make_split departs from them: dbgen's sparse orderkeys and 1 to 7
lineitems an order, uniform (make_split: dense keys, Poisson(4)).
Nothing here imports the program: the tables are plain tensors, and a
string column is a pair (int32 offsets, uint8 chars).
"""

from __future__ import annotations

import numpy as np
import torch

PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")


def sub_seed(seed: int, *path: int) -> int:
    """An independent 63-bit seed for stream ``path`` of ``seed``."""
    state = np.random.SeedSequence((seed, *path)).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def generator(device, seed: int, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *path))


def _iota(n: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int64, device=device)


def build_probe(gen: torch.Generator, build_rows: int, probe_rows: int, selectivity: float,
                rand_max: int) -> dict:
    """{build_keys, build_payload, probe_keys, probe_payload, matches,
    complement}: int64 keys, iota payloads, the exact match count (a 0-d
    int64 tensor) and the keys of [0, rand_max] no build row holds."""
    if rand_max + 1 <= build_rows:
        raise ValueError("need rand_max + 1 > build_rows so that probe misses exist")
    dev = gen.device
    perm = torch.randperm(rand_max + 1, generator=gen, device=dev)
    build_keys, complement = perm[:build_rows], perm[build_rows:]
    probe_keys, matches = draw_probe(gen, build_keys, complement, probe_rows, selectivity)
    return {"build_keys": build_keys, "build_payload": _iota(build_rows, dev),
            "probe_keys": probe_keys, "probe_payload": _iota(probe_rows, dev),
            "matches": matches, "complement": complement}


def draw_probe(gen: torch.Generator, build_keys: torch.Tensor, complement: torch.Tensor,
               rows: int, selectivity: float) -> tuple:
    """(probe keys, exact matches against unique ``build_keys``)."""
    dev = build_keys.device
    hit = torch.rand(rows, generator=gen, device=dev) < selectivity
    hit_idx = torch.randint(0, build_keys.shape[0], (rows,), generator=gen, device=dev)
    miss_idx = torch.randint(0, max(1, complement.shape[0]), (rows,), generator=gen, device=dev)
    keys = torch.where(hit, build_keys[hit_idx], complement[miss_idx])
    return keys, hit.sum(dtype=torch.int64)


def world_build_probe(device, seed: int, rank: int, world: int, build_rows: int,
                      probe_rows: int, selectivity: float) -> dict:
    """Rank ``rank``'s share of a world's draw: one permutation of [0,
    2 * world * build_rows] from ``seed`` (the same on every rank) gives
    the world's unique build keys, of which this rank holds block
    ``rank``, and their complement; this rank's probe keys hit build
    keys of every rank. Payloads are global row ids (rank * rows + i),
    so the world's rows are unique. ``matches`` is this rank's probe
    rows' exact match count."""
    g = generator(device, seed, 0)
    n_build = world * build_rows
    perm = torch.randperm(2 * n_build + 1, generator=g, device=device)
    all_build, complement = perm[:n_build], perm[n_build:]
    keys = all_build[rank * build_rows:(rank + 1) * build_rows].clone()
    probe_keys, matches = draw_probe(generator(device, seed, 1, rank), all_build, complement,
                                     probe_rows, selectivity)
    return {"build_keys": keys, "build_payload": _iota(build_rows, device, rank * build_rows),
            "probe_keys": probe_keys, "probe_payload": _iota(probe_rows, device,
                                                              rank * probe_rows),
            "matches": matches}


def world_build_side(device, seed: int, world: int, build_rows: int) -> tuple:
    """The whole world's build side of ``world_build_probe`` (keys,
    global row ids), drawn again from ``seed``."""
    g = generator(device, seed, 0)
    n_build = world * build_rows
    perm = torch.randperm(2 * n_build + 1, generator=g, device=device)
    return perm[:n_build].clone(), _iota(n_build, device)


def pick_strings(words, code: torch.Tensor) -> tuple:
    """(offsets, chars) of the string column whose row i is
    ``words[code[i]]``."""
    dev = code.device
    enc = [w.encode() for w in words]
    lens = torch.tensor([len(w) for w in enc], dtype=torch.int64, device=dev)
    flat = torch.frombuffer(bytearray(b"".join(enc)), dtype=torch.uint8).to(dev)
    word_start = torch.cumsum(lens, 0) - lens
    sizes = lens[code]
    offsets = torch.zeros(code.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(sizes, 0, out=offsets[1:])
    nbytes = int(offsets[-1])
    row = torch.repeat_interleave(torch.arange(code.shape[0], device=dev), sizes,
                                  output_size=nbytes)
    src = word_start[code][row] + torch.arange(nbytes, device=dev) - offsets[row]
    return offsets.to(torch.int32), flat[src]


def tpch_split(gen: torch.Generator, split: int, n_orders: int, lineitems_min: int,
               lineitems_max: int) -> dict:
    """One split of TPC-H: {o_orderkey, o_orderpriority (offsets, chars),
    l_orderkey}. The split holds orders
    [split * n_orders, (split + 1) * n_orders) of the scale, shuffled,
    each keyed as dbgen keys order i (the first 8 keys of every 32:
    (i // 8) * 32 + i % 8 + 1); each order has a uniform
    [lineitems_min, lineitems_max] lineitems, shuffled."""
    dev = gen.device
    g = torch.randperm(n_orders, generator=gen, device=dev) + split * n_orders
    o_orderkey = (g // 8) * 32 + g % 8 + 1
    del g
    code = torch.randint(0, len(PRIORITIES), (n_orders,), generator=gen, device=dev)
    n_items = torch.randint(lineitems_min, lineitems_max + 1, (n_orders,), generator=gen,
                            device=dev)
    n_li = int(n_items.sum())
    l_orderkey = torch.repeat_interleave(o_orderkey, n_items, output_size=n_li)
    l_orderkey = l_orderkey[torch.randperm(n_li, generator=gen, device=dev)]
    return {"o_orderkey": o_orderkey, "o_orderpriority": pick_strings(PRIORITIES, code),
            "l_orderkey": l_orderkey}


def log_uniform_sizes(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` sizes at the quantiles (i + 0.5) / n of the log-uniform law
    on [lo, hi]: every seed gets the same set, in its own order."""
    q = (np.arange(n) + 0.5) / n
    return np.round(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))).astype(np.int64)


def poisson_gaps(n: int, rate: float) -> np.ndarray:
    """``n`` gaps at the quantiles (i + 0.5) / n of the exponential law
    of mean 1 / ``rate``: Poisson arrivals whose set is the same for
    every seed."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate
