"""The port's fused cross-entropy (its plain path, through the same
``torch.autograd.Function`` the card uses) against the JAX package's
``fused_ce.softmax_cross_entropy`` in Pallas interpret mode, on the same
numpy inputs: loss, lse and dx, including labels outside [0, V) (label
logit 0, so loss = lse, and no one-hot in dx).

Tolerances: the loss and lse are f32 on both sides, apart by the order of
the row sums (readings below 1e-6): atol 1e-5. dx in float32 within 1e-6
(readings below 1e-8); in bfloat16 both sides round the same f32 value
once, apart by one bf16 ulp at most: |err| <= 1e-6 + 2^-7·|want|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_ce as jce
from paddle_tpu_torch.ops import fused_ce as tce


def _inputs(N, V, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, V)) * 3).astype(np.float32)
    lbl = rng.integers(0, V, N).astype(np.int64)
    lbl[1], lbl[5] = V + 3, -2            # outside [0, V)
    g = rng.uniform(0.5, 1.5, N).astype(np.float32)
    return x, lbl, g


@pytest.mark.parametrize("dtype,N,V", [("float32", 32, 384),
                                       ("float32", 16, 1000),
                                       ("bfloat16", 32, 512)])
def test_fused_ce_matches_jax(dtype, N, V):
    x, lbl, g = _inputs(N, V, seed=N + V)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jl = jnp.asarray(lbl, jnp.int32)
    j_loss, j_lse = jce._ce_fwd(jx, jl)
    _, vjp = jax.vjp(lambda a: jce.softmax_cross_entropy(a, jl), jx)
    (j_dx,) = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tl = torch.from_numpy(lbl)
    loss = tce.softmax_cross_entropy(tx, tl)
    loss.backward(torch.from_numpy(g))
    _, lse = tce._ce_fwd_plain(tx.detach(), tl)

    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=1e-5,
                               rtol=0)
    # out-of-range labels: the loss is the lse itself
    assert torch.equal(loss.detach()[[1, 5]], lse[[1, 5]])
    assert tx.grad.dtype == tx.dtype
    atol, rtol = (1e-6, 0.0) if dtype == "float32" else (1e-6, 2 ** -7)
    np.testing.assert_allclose(
        tx.grad.to(torch.float32).numpy(),
        np.asarray(jnp.asarray(j_dx, jnp.float32)), atol=atol, rtol=rtol)


def test_fused_ce_masked_logits_match_jax():
    """Rows where all but a few logits are -inf (a masked vocabulary):
    finite loss and lse, and a dx of exactly 0 at every masked entry."""
    N, V = 16, 1000
    x, lbl, g = _inputs(N, V, seed=7)
    x[:, 6:] = -np.inf
    lbl = lbl % 6
    jl = jnp.asarray(lbl, jnp.int32)
    j_loss, j_lse = jce._ce_fwd(jnp.asarray(x), jl)
    _, vjp = jax.vjp(lambda a: jce.softmax_cross_entropy(a, jl),
                     jnp.asarray(x))
    (j_dx,) = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_()
    loss = tce.softmax_cross_entropy(tx, torch.from_numpy(lbl))
    loss.backward(torch.from_numpy(g))
    assert torch.isfinite(loss).all() and torch.isfinite(tx.grad).all()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss),
                               atol=1e-5, rtol=0)
    assert not tx.grad[:, 6:].any()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_dx), atol=1e-6,
                               rtol=0)


def test_causal_lm_loss_matches_jax():
    B, S, V = 2, 16, 256
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, V)).astype(np.float32)
    lbl = rng.integers(0, V, (B, S))
    j = jax.value_and_grad(lambda a: jce.causal_lm_loss(
        a, jnp.asarray(lbl, jnp.int32)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    loss = tce.causal_lm_loss(tx, torch.from_numpy(lbl))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j[0]), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j[1]), atol=1e-8,
                               rtol=0)


def test_fused_ce_checks_shapes():
    with pytest.raises(ValueError, match=r"logits \(N, V\)"):
        tce.softmax_cross_entropy(torch.zeros((4, 8)),
                                  torch.zeros(3, dtype=torch.long))
