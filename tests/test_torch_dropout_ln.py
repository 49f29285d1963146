"""The port's ``fused_dropout_add_layer_norm`` (its plain forward, which CPU
tensors take, and its plain backward) against the JAX package's, with the
same explicit dropout bits: the Pallas kernel in interpret mode where N is
a multiple of its row block, the reference's dense fallback for a ragged
N. Gradients are held against ``jax.vjp``.

The bits include the edges of the keep decision (keep = f32(bits) / 2^32
>= p, the bits read as unsigned and rounded to nearest): bits that round
up onto f32(p) * 2^32, bits from 2^31 up (a signed reading would drop
them), and bits near 2^32, which round to u = 1.0. The forward must keep
exactly the elements the reference keeps.

Tolerances. float32: f32 statistics on both sides, apart by the order of
the row sums: out within 1e-5 absolute and relative; dx and dres the
same; dw and db, sums over N rows, within 1e-4. bfloat16: the same f32
values rounded to bfloat16 once, one bf16 ulp apart at most: 2^-7 of the
size (1e-5 absolute near 0; dw and db 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.dropout_ln import \
    fused_dropout_add_layer_norm as jax_fdln
from paddle_tpu_torch.ops.dropout_ln import (_as_bits, _uniform,
                                             fused_dropout_add_layer_norm)

P_EDGE = int(np.float32(0.1).astype(np.float64) * 2 ** 32)  # 429496736
EDGE_BITS = np.array([
    0, 1, P_EDGE - 17, P_EDGE - 16, P_EDGE - 15, P_EDGE - 1, P_EDGE,
    P_EDGE + 1, 2 ** 31 - 65, 2 ** 31 - 64, 2 ** 31 - 1, 2 ** 31,
    2 ** 31 + 1, 2 ** 32 - 129, 2 ** 32 - 128, 2 ** 32 - 1], np.uint32)
TOL = {"float32": dict(out=(1e-5, 1e-5), sums=(1e-4, 1e-5)),
       "bfloat16": dict(out=(1e-5, 2 ** -7), sums=(1e-3, 2 ** -7))}


def _bits(N, H, seed):
    bits = np.random.default_rng(seed).integers(0, 2 ** 32, (N, H),
                                                dtype=np.uint64)
    bits = bits.astype(np.uint32)
    for i in range(N):          # every row starts with the edges, shifted
        row = np.roll(EDGE_BITS, i)
        bits[i, :min(H, row.size)] = row[:H]
    return bits


def _expected_keep(bits, p):
    """The reference's decision, in numpy: uint32 -> f32 rounds to
    nearest, / 2^32 is exact."""
    return bits.astype(np.float32) / np.float32(2 ** 32) >= np.float32(p)


def _inputs(N, H, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H)).astype(np.float32)
    res = rng.standard_normal((N, H)).astype(np.float32)
    w = (1 + 0.5 * rng.standard_normal(H)).astype(np.float32)
    b = rng.standard_normal(H).astype(np.float32)
    g = rng.standard_normal((N, H)).astype(np.float32)
    return x, res, w, b, g


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=rtol)


def test_uniform_matches_the_reference_at_the_edges():
    """u of the port equals the reference's u for every edge value, for
    the bits given as uint32 and as int32 holding the same bits."""
    want = np.asarray(jnp.asarray(EDGE_BITS, jnp.uint32)
                      .astype(jnp.float32) / 4294967296.0)
    u32 = torch.from_numpy(EDGE_BITS.copy())
    i32 = torch.from_numpy(EDGE_BITS.view(np.int32).copy())
    for bits in (u32, i32):
        got = _uniform(_as_bits(bits, (1, EDGE_BITS.size)))[0].numpy()
        np.testing.assert_array_equal(got, want)
    assert want[-1] == 1.0 and want[11] == 0.5 and want[10] == 0.5


# (N, H): N = 256 runs the reference's Pallas kernel (row block 128);
# N = 130 is ragged, the reference's dense fallback
@pytest.mark.parametrize("N,H", [(256, 128), (130, 100)])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_add_ln_matches_jax(N, H, p, training, dtype):
    x, res, w, b, g = _inputs(N, H, seed=N + H)
    bits = _bits(N, H, seed=H)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jr, jw, jb, jg = (jnp.asarray(a, jd) for a in (x, res, w, b, g))
    jbits = jnp.asarray(bits, jnp.uint32)
    want, vjp = jax.vjp(
        lambda a, r, ww, bb: jax_fdln(a, r, ww, bb, p=p, eps=1e-5,
                                      training=training, bits=jbits),
        jx, jr, jw, jb)
    want_grads = vjp(jg)

    tx, tr, tw, tb = (torch.from_numpy(a).to(td).requires_grad_()
                      for a in (x, res, w, b))
    out = fused_dropout_add_layer_norm(tx, tr, tw, tb, p=p, eps=1e-5,
                                       training=training,
                                       bits=torch.from_numpy(bits))
    out.backward(torch.from_numpy(g).to(td))
    tol = TOL[dtype]
    assert out.dtype == td
    _close(out, want, *tol["out"])
    for got, w_ in zip((tx.grad, tr.grad), want_grads[:2]):
        assert got.dtype == td
        _close(got, w_, *tol["out"])
    for got, w_ in zip((tw.grad, tb.grad), want_grads[2:]):
        assert got.dtype == td
        _close(got, w_, *tol["sums"])


@pytest.mark.parametrize("N,H", [(256, 128), (130, 100)])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_add_ln_keeps_the_elements_the_reference_keeps(N, H, p):
    """x = 100 everywhere, |residual| < 1, weight 1, bias 0: a kept element
    normalises above 0 and a dropped one below, so the sign of the output
    shows the keep mask exactly. Both sides keep what the numpy reading
    of the reference's rule keeps."""
    rng = np.random.default_rng(1)
    x = np.full((N, H), 100.0, np.float32)
    res = rng.uniform(-1, 1, (N, H)).astype(np.float32)
    w, b = np.ones(H, np.float32), np.zeros(H, np.float32)
    bits = _bits(N, H, seed=7)
    want = _expected_keep(bits, p)
    assert 0 < want.mean() < 1
    j_out = np.asarray(jax_fdln(jnp.asarray(x), jnp.asarray(res),
                                jnp.asarray(w), jnp.asarray(b), p=p,
                                training=True,
                                bits=jnp.asarray(bits, jnp.uint32)))
    for given in (torch.from_numpy(bits),
                  torch.from_numpy(bits.view(np.int32))):
        out = fused_dropout_add_layer_norm(
            torch.from_numpy(x), torch.from_numpy(res), torch.from_numpy(w),
            torch.from_numpy(b), p=p, training=True, bits=given)
        np.testing.assert_array_equal(out.numpy() > 0, want)
    np.testing.assert_array_equal(j_out > 0, want)


def test_dropout_add_ln_draws_bits_from_the_generator():
    """Without bits, a training call draws them from the generator given:
    the same seed gives the same output, another seed another one; an
    eval call is deterministic and reads no bits."""
    x, res, w, b, _ = (torch.from_numpy(a) for a in _inputs(64, 32, 0))

    def run(seed, training=True):
        gen = torch.Generator().manual_seed(seed)
        return fused_dropout_add_layer_norm(x, res, w, b, p=0.5,
                                            training=training,
                                            generator=gen)

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert torch.equal(run(3, False), run(4, False))
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        fused_dropout_add_layer_norm(x, res, w, b, p=1.0)
    with pytest.raises(TypeError, match="uint32"):
        fused_dropout_add_layer_norm(x, res, w, b, bits=torch.zeros(
            (64, 32), dtype=torch.int64))
