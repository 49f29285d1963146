"""The tiling that the attention kernels of ``kernels/flash_tiles.cuh``
and the port's wrappers share, checked on the CPU (no kernel runs here):

* the Python tile constants (``_TILES``, the per-dtype ``_DKV_ROWS``) are
  the header's ``constexpr``s, read from its text;
* the splash dk/dv column tables at the bf16 dk/dv query tile (64 rows:
  G heads x 64 / G positions where G divides 64, else 64 positions of one
  head) visit every live (query, key) pair exactly once and mark as full
  exactly the tiles with no masked pair, on the causal triangle, Mistral's
  band, a random mask with an empty row, mask blocks of 16, a shifted
  query frame and a kv group of 3.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention_gqa as fa
from paddle_tpu_torch.ops import splash_attention as sa
from paddle_tpu_torch.ops.kernels import _build

HEADER = Path(_build.KERNEL_DIR) / "flash_tiles.cuh"


def _constexpr(name):
    m = re.search(rf"constexpr int {name} = (\d+);", HEADER.read_text())
    assert m, f"{name} not found in {HEADER.name}"
    return int(m.group(1))


@pytest.mark.parametrize("dtype,rows,keys,dkv_rows",
                         [(torch.bfloat16, "kRows", "kKeys", "kDkvRows"),
                          (torch.float16, "kRows", "kKeys", "kDkvRows"),
                          (torch.float32, "BM", "BK", "BM")])
def test_tile_constants_match_the_header(dtype, rows, keys, dkv_rows):
    assert fa._TILES[dtype] == (_constexpr(rows), _constexpr(keys))
    assert fa._DKV_ROWS[dtype] == _constexpr(dkv_rows)


def test_bf16_query_tile_is_the_wgmma_m():
    """The bf16 backward's query tile is one wgmma M of 64 rows (one
    warpgroup of 128 threads), for dq and dk/dv alike, and every tile is a
    whole number of 64-column boxes."""
    assert fa._DKV_ROWS[torch.bfloat16] == fa._TILES[torch.bfloat16][0] == 64
    assert _constexpr("kBwdThreads") == 128 and _constexpr("kHalf") == 64


def test_group_tile_matches_the_header():
    """The heads of a row tile: the header's ``group_tile`` rule, which
    the Python tables (``_group_tile``) must follow for every G."""
    m = re.search(r"constexpr int group_tile\(int G, int rows\) \{\s*"
                  r"return rows % G == 0 \? G : 1;\s*\}", HEADER.read_text())
    assert m, "group_tile's rule changed in the header"
    for rows in (32, 64):
        for G in range(1, 129):
            gt = fa._group_tile(G, rows)
            assert gt == (G if rows % G == 0 else 1)
            assert rows % gt == 0 and G % gt == 0


def test_the_16bit_kernels_use_no_mma_sync():
    """Forward, dq and dk/dv are on wgmma: no mma.sync instruction (nor
    its fragment loaders) is left in the header."""
    text = HEADER.read_text()
    assert "mma.sync" not in text
    for gone in ("copy_rows_t", " load_a(", " load_b(", " c_to_a(",
                 "mma_fwd_smem", "kPad"):
        assert gone not in text, gone
    assert text.count("wgmma.mma_async") == 4      # SS64, RS64/128/256


def _random_mask(nq, nk, seed, empty_row):
    bm = np.random.default_rng(seed).random((nq, nk)) < 0.5
    bm[:, 0] = True
    bm[empty_row] = False
    return bm


# (name, Sq, Sk, G, block mask, block_q, block_k, causal, window, q_offset)
COLUMN_CASES = [
    ("causal_g1", 512, 512, 1, np.ones((4, 4), bool), 128, 128, True, None,
     0),
    ("causal_g4", 512, 512, 4, np.ones((4, 4), bool), 128, 128, True, None,
     0),
    ("mistral_band", 8192, 8192, 4,
     sa.banded_block_mask(8192, 8192, 128, 128, 4096), 128, 128, True, 4096,
     0),
    ("random_empty_row", 512, 512, 2, _random_mask(4, 4, 0, 2), 128, 128,
     False, None, 0),
    ("blocks16", 512, 512, 4, _random_mask(32, 32, 1, 7), 16, 16, True, None,
     0),
    ("q_offset", 256, 512, 4, np.ones((2, 4), bool), 128, 128, True, 200,
     256),
    ("band_g3", 1024, 1024, 3,
     sa.banded_block_mask(1024, 1024, 64, 64, 300), 64, 64, True, 300, 0),
]


@pytest.mark.parametrize("case", COLUMN_CASES, ids=[c[0] for c in COLUMN_CASES])
def test_dkv_columns_cover_every_live_pair_once(case):
    """Replays the dk/dv kernel's walk over the tables it is handed: for
    each 64-key tile, the query tiles of its column (64 / GT positions,
    GT = ``_group_tile(G, 64)``), and counts how often each (position,
    key) pair is visited."""
    _, Sq, Sk, G, bm, bq, bk, causal, window, off = case
    q = torch.empty((1, G, Sq, 64), dtype=torch.bfloat16)
    k = torch.empty((1, 1, Sk, 64), dtype=torch.bfloat16)
    pat = sa._pattern(q, k, bm, causal, bq, bk, window, off)
    _, _, cols, counts, _ = sa._device_tables(pat, Sq, Sk, G, torch.bfloat16,
                                              "cpu")
    cols, counts = cols.numpy(), counts.numpy()
    rows = fa._DKV_ROWS[torch.bfloat16]
    BQ, keys = rows // fa._group_tile(G, rows), fa._TILES[torch.bfloat16][1]
    live = sa._live_pairs(pat, Sq, Sk, "cpu").numpy()
    seen = np.zeros((Sq, Sk), np.int32)
    assert len(counts) == Sk // keys
    for kt, n in enumerate(counts):
        k0 = kt * keys
        for e in cols[kt, :n]:
            p0 = (e >> 1) * BQ
            tile = live[p0:p0 + BQ, k0:k0 + keys]
            assert tile.any(), "a tile with no live pair is visited"
            assert bool(e & 1) == (not tile.all()), "partial flag is wrong"
            seen[p0:p0 + BQ, k0:k0 + keys] += 1
    assert (seen[live] == 1).all()
    if case[0] == "random_empty_row":
        assert (~live.any(1)).any()
