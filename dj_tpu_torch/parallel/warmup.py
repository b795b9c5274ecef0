"""Warmups: pay one-time set-up costs before timing.

Counterpart of ``warmup_compression`` in ``dj_tpu/parallel/warmup.py``
(the reference's warmup_nvcomp, compression.cpp:170-196). The other
warmups of dj_tpu (warmup_all_to_all, warmup_join_index,
warmup_prepared_join) come with the composition layers (ROADMAP item 9).
"""

from __future__ import annotations

import torch

from ..compress import cascaded as cz


def warmup_compression(itemsize: int = 8, bucket_rows: int = 4096, device=None) -> None:
    """One codec round trip of two dummy [bucket_rows] buckets of
    ``itemsize``-byte ints under the full cascade (RLE, delta, bitpack)
    on ``device`` (default the current CUDA device), which also builds
    the expand_ranks kernel of the RLE decode if nothing has built it
    yet. Raises if the round trip does not give back its input."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    opts = cz.CascadedOptions(num_rles=1, num_deltas=1, use_bp=True)
    cap = cz.compressed_capacity_words(bucket_rows * itemsize, 1.0)
    dtype = cz._INT_OF_SIZE[itemsize]
    x = torch.arange(2 * bucket_rows, device=dev).to(dtype).reshape(2, bucket_rows)
    counts = torch.full((2,), bucket_rows, dtype=torch.int32, device=dev)
    words, _, overflow = cz.compress_buckets(x, itemsize, opts, cap, counts)
    back = cz.decompress_buckets(words, itemsize, opts, bucket_rows, dtype)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if bool(overflow.any()) or not torch.equal(back, x):
        raise RuntimeError("warmup_compression: the codec's round trip changed its input")
