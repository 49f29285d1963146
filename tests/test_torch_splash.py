"""The port's ``splash_attention`` (its plain path, through the same
``torch.autograd.Function`` the card uses) against the JAX package's
``splash_attention`` run as the JAX package's own tests run it on the CPU
(Pallas interpret mode), in both of its modes: K/V resident and live K/V
blocks streamed (``_FORCE_STREAM``, as ``tests/test_splash_attention.py``
forces it). Same numpy inputs; out, lse and dq/dk/dv through ``jax.vjp``
against ``backward``, for G = 1, 2 and 4 on: the sliding-window band, a
random mask with an empty block row, a live block wholly above the causal
diagonal, and a shifted query frame (``q_offset``, Sq != Sk). Then the
host helpers: ``banded_block_mask`` and the pattern tables equal the
reference's, and the kernels' walks cover every live pair.

Tolerances. float32: both sides sum in f32 and differ only in order: out
and lse within 1e-5, gradients within 1e-4 (readings: out 4e-7, gradients
4e-6 at most). bfloat16: the same roundings (q2, probabilities and ds to
bf16) on f32 sums in another order; the reference rounds each probability
against the running max, the plain version against the final one, so an
output element may land two bf16 ulps apart: |err| <= 1e-3 + 2^-6·|want|
(reading: err/limit 0.83). A gradient adds the output's difference,
carried through delta = rowsum(do·out) into ds = p·(dp - delta), where
dp - delta cancels: |err| <= 4e-3 + 2^-6·|want| (reading 0.58; at
1e-3 + 2^-7·|want| the readings were 1.9). Rows with no live key: out 0
and lse NEG_INF on both sides, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import splash_attention as jsplash
from paddle_tpu_torch.ops import splash_attention as tsplash

B, HKV, D = 1, 2, 64
NEG_INF = -1e30
TOL = {"float32": dict(out=(1e-5, 0.0), grad=(1e-4, 0.0)),
       "bfloat16": dict(out=(1e-3, 2 ** -6), grad=(4e-3, 2 ** -6))}


def _random_mask(nq, nk, seed, empty_row):
    bm = np.random.default_rng(seed).random((nq, nk)) < 0.5
    bm[:, 0] = True
    bm[empty_row] = False
    return bm


# (name, dtype, G, Sq, Sk, block_q, block_k, mask, causal, window, q_offset)
CASES = [
    ("band_g1", "float32", 1, 256, 256, 64, 64,
     jsplash.banded_block_mask(256, 256, 64, 64, 100), True, 100, 0),
    ("band_g4", "bfloat16", 4, 256, 256, 64, 64,
     jsplash.banded_block_mask(256, 256, 64, 64, 100), True, 100, 0),
    ("random_empty_row", "float32", 2, 256, 256, 64, 64,
     _random_mask(4, 4, 0, 2), False, None, 0),
    ("above_diagonal", "float32", 1, 256, 256, 128, 128,
     np.array([[False, True], [True, True]]), True, None, 0),
    ("q_offset", "float32", 2, 128, 256, 64, 64,
     np.ones((2, 4), bool), True, 100, 128),
]


def _inputs(G, Sq, Sk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV * G, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, Sk, D)).astype(np.float32)
    do = rng.standard_normal((B, HKV * G, Sq, D)).astype(np.float32)
    return q, k, v, do


def _close(got, want, atol, rtol):
    got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_splash_matches_jax(case, stream, monkeypatch):
    _, dtype, G, Sq, Sk, bq, bk, bm, causal, window, off = case
    monkeypatch.setattr(jsplash, "_FORCE_STREAM", stream)
    q, k, v, do = _inputs(G, Sq, Sk, seed=Sq + G)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jd) for a in (q, k, v, do))
    j_out, (_, _, _, _, j_lse) = jsplash._splash_fwd(
        jq, jk, jv, bm, causal, None, bq, bk, window, off)
    _, vjp = jax.vjp(lambda a, b, c: jsplash.splash_attention(
        a, b, c, bm, causal, None, bq, bk, window, off), jq, jk, jv)
    j_grads = vjp(jdo)

    tq, tk, tv = (torch.from_numpy(a).to(td).requires_grad_()
                  for a in (q, k, v))
    out = tsplash.splash_attention(tq, tk, tv, bm, causal, None, bq, bk,
                                   window, off)
    out.backward(torch.from_numpy(do).to(td))
    pat = tsplash._pattern(tq, tk, bm, causal, bq, bk, window, off)
    _, lse = tsplash._splash_fwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                       pat)

    tol = TOL[dtype]
    _close(out, j_out, *tol["out"])
    _close(lse, j_lse, 1e-5, 0.0)
    empty = ~tsplash._live_pairs(pat, Sq, Sk, "cpu").any(-1)
    if case[0] in ("random_empty_row", "above_diagonal"):
        assert empty.any()
    assert (lse[..., empty] == NEG_INF).all()
    assert not out.detach()[:, :, empty].any()
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        assert got.dtype == td and torch.isfinite(got).all()
        _close(got, want, *tol["grad"])
    assert tk.grad.shape == (B, HKV, Sk, D)      # the true kv head count


@pytest.mark.parametrize("Sq,Sk,bq,bk,window,causal",
                         [(256, 256, 64, 64, 100, True),
                          (8192, 8192, 128, 128, 4096, True),
                          (512, 1024, 128, 64, None, True),
                          (512, 512, 64, 128, 1, False),
                          (384, 384, 128, 128, 1000, True)])
def test_banded_block_mask_matches_the_reference(Sq, Sk, bq, bk, window,
                                                 causal):
    got = tsplash.banded_block_mask(Sq, Sk, bq, bk, window, causal)
    want = jsplash.banded_block_mask(Sq, Sk, bq, bk, window, causal)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pattern_tables_match_the_reference(seed):
    bm = _random_mask(7, 9, seed, empty_row=seed + 1)
    got, want = tsplash._pattern_tables(bm), jsplash._pattern_tables(bm)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


WALK_CASES = [
    # (Sq, Sk, block_q, block_k, mask seed or None (banded), causal,
    #  window, q_offset, tile_q, tile_k)
    (8192, 8192, 128, 128, None, True, 4096, 0, 16, 64),
    (8192, 8192, 128, 128, None, True, 4096, 0, 8, 64),
    (512, 512, 16, 16, 3, True, None, 0, 16, 64),
    (256, 512, 64, 64, 4, True, 100, 256, 32, 64),
    (256, 256, 128, 128, 5, False, 50, 0, 64, 32),
]


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_covers_every_live_pair(case):
    """The kernels visit exactly the tiles that hold a live pair, and ask
    the mask per element exactly in the tiles that also hold a dead one:
    checked against the elementwise live pairs, tile by tile."""
    Sq, Sk, bq, bk, seed, causal, window, off, tq, tk = case
    bm = (tsplash.banded_block_mask(Sq, Sk, bq, bk, window) if seed is None
          else _random_mask(Sq // bq, Sk // bk, seed, empty_row=1))
    pat = tsplash._pattern(torch.empty(1, 1, Sq, 1), torch.empty(1, 1, Sk, 1),
                           bm, causal, bq, bk, window, off)
    pairs = tsplash._live_pairs(pat, Sq, Sk, "cpu").numpy()
    tiles = pairs.reshape(Sq // tq, tq, Sk // tk, tk)
    want_live = tiles.any(axis=(1, 3))
    want_full = tiles.all(axis=(1, 3))
    entries, counts = tsplash._walk(*tsplash._tile_tables(pat, Sq, Sk, tq,
                                                          tk))
    assert np.array_equal(counts, want_live.sum(1))
    for i, n in enumerate(counts):
        cols, partial = entries[i, :n] >> 1, entries[i, :n] & 1
        assert np.array_equal(cols, np.flatnonzero(want_live[i]))
        assert np.array_equal(partial == 1, ~want_full[i, cols])


def test_splash_refuses_a_mask_that_does_not_tile():
    q = torch.zeros((1, 2, 256, 64))
    with pytest.raises(ValueError, match="does not tile"):
        tsplash.splash_attention(q, q, q, np.ones((3, 2), bool))
    with pytest.raises(ValueError, match="window"):
        tsplash.splash_attention(q, q, q, np.ones((2, 2), bool), True,
                                 window=0)


def test_grouped_alias_and_no_launch_on_the_cpu():
    assert tsplash.grouped_splash_attention is tsplash.splash_attention
    spl = tsplash.splash_attention
    q = torch.randn((1, 4, 256, 64), requires_grad=True)
    k = torch.randn((1, 2, 256, 64), requires_grad=True)
    before = (spl.launches_fwd, spl.launches_dq, spl.launches_dkv)
    spl(q, k, k, np.ones((2, 2), bool), True).sum().backward()
    assert (spl.launches_fwd, spl.launches_dq, spl.launches_dkv) == before
