"""dj_tpu_torch join_scans (plain version) vs the Pallas join_scans.

Packed operands are built the way dj_tpu's _packed_merged_sort builds
them (as tests/test_pallas_scan.py does); the Pallas kernel runs in
interpret mode with a 256-element tile. All four int32 outputs must be
equal everywhere. The CUDA kernel itself is checked on the card by
chip_smoke.py; here the wrapper's CPU route and its input checks are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dj_tpu.ops import pallas_scan as psc
from dj_tpu_torch.ops import cuda_build, scan


def _pack(keys_r, keys_l, L, R, tag_bits):
    S = L + R
    tag_r = np.arange(len(keys_r), dtype=np.uint64)
    tag_l = np.arange(len(keys_l), dtype=np.uint64) + np.uint64(R)
    words = np.concatenate(
        [
            (keys_r.astype(np.uint64) << np.uint64(tag_bits)) | tag_r,
            (keys_l.astype(np.uint64) << np.uint64(tag_bits)) | tag_l,
        ]
    )
    pad = np.full(S - len(words), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    return np.sort(np.concatenate([words, pad]))


CASES = {
    # name: (l_count, r_count, L, R, key values)
    "dups_both_sides": (500, 400, 700, 600, 50),
    "mostly_unique_full": (1000, 1000, 1000, 1000, 5000),
    "single_giant_run": (300, 290, 300, 300, 1),
    "all_padding": (0, 0, 200, 100, 3),
    "empty_ref_side": (9, 0, 16, 16, 3),
    "S_not_tile_multiple": (333, 211, 345, 222, 20),
    # S at 1 and at the 256-position tile of the Pallas kernel, +- 1
    "S_is_1": (0, 1, 0, 1, 3),
    "S_is_tile_minus_1": (100, 155, 100, 155, 7),
    "S_is_tile": (128, 128, 128, 128, 7),
    "S_is_tile_plus_1": (129, 128, 129, 128, 7),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_join_scans_plain_matches_pallas(case, seed):
    l_count, r_count, L, R, kmax = CASES[case]
    rng = np.random.default_rng(seed)
    S = L + R
    tag_bits = max(1, S.bit_length())
    sp = _pack(rng.integers(0, kmax, r_count), rng.integers(0, kmax, l_count), L, R, tag_bits)
    want = psc.join_scans(
        jnp.asarray(sp), jnp.int32(l_count), jnp.int32(r_count),
        tag_bits=tag_bits, L=L, R=R, tile=256, interpret=True,
    )
    sp_t = torch.from_numpy(sp.view(np.int64))
    got = scan.join_scans(sp_t, l_count, r_count, tag_bits, L, R)
    plain = scan.join_scans_plain(sp_t, torch.tensor(l_count), torch.tensor(r_count), tag_bits, L, R)
    for name, w, g, p in zip(("stag", "run_start", "cnt", "csum"), want, got, plain):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(p.numpy(), np.asarray(w), err_msg=name)


def test_csum_wraps_like_int32():
    """A run whose match count passes 2^31 wraps csum exactly as the
    Pallas kernel's int32 csum does."""
    L = R = 70_000
    S = L + R
    tag_bits = S.bit_length()
    sp = _pack(np.zeros(R, np.int64), np.zeros(L, np.int64), L, R, tag_bits)
    want = psc.join_scans(
        jnp.asarray(sp), jnp.int32(L), jnp.int32(R),
        tag_bits=tag_bits, L=L, R=R, tile=256, interpret=True,
    )
    got = scan.join_scans(torch.from_numpy(sp.view(np.int64)), L, R, tag_bits, L, R)
    assert int(got[2].sum(dtype=torch.int64)) == L * R > 2**31
    for name, w, g in zip(("stag", "run_start", "cnt", "csum"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_join_scans_rejects_bad_inputs():
    sp = torch.zeros(10, dtype=torch.int64)
    with pytest.raises(ValueError):
        scan.join_scans(sp.to(torch.int32), 5, 5, 4, 5, 5)
    with pytest.raises(ValueError):
        scan.join_scans(sp, 5, 5, 3, 5, 5)  # 3 tag bits cannot tag S = 10
    with pytest.raises(ValueError):
        scan.join_scans(sp[:9], 5, 5, 4, 5, 5)
    with pytest.raises(ValueError):
        scan.join_scans(sp.to("meta"), 5, 5, 4, 5, 5)


def test_cpu_route_launches_no_kernel():
    before = scan.launches
    sp = torch.from_numpy(_pack(np.arange(4), np.arange(4), 4, 4, 4).view(np.int64))
    scan.join_scans(sp, 4, 4, 4, 4, 4)
    assert scan.launches == before


def test_kernel_sources_carry_their_note():
    """Each CUDA source names the TPU kernel it replaces, its bound on
    the card and its design."""
    names = {p.stem for p in cuda_build.sources()}
    assert names == {
        "join_scans", "expand_values", "merge_sorted_u64", "expand_ranks",
        "expand_gather", "expand_join", "expand_carry", "expand_vfull",
        "tile_sort", "cluster_gather", "take_gather",
    }
    for p in cuda_build.sources():
        text = p.read_text()
        assert ("Replaces the TPU kernel dj_tpu/ops/" in text
                or "Replaces the TPU kernel scripts/hw/" in text)
        assert "Bound on this card" in text and "Design:" in text
        assert "extern \"C\" int dj_" in text
