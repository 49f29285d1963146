"""The port's chunked-vocabulary CE (``paddle_tpu_torch/ops/chunked_ce.py``)
against the JAX package's (``paddle_tpu/ops/chunked_ce.py``) on the same
numpy-seeded inputs: the loss, ``dx`` and ``dw``, at vocabularies the
chunk divides and does not (the pad path); then the chunked loss against
the dense f32 log-softmax loss in the port itself; bf16 inputs; and the
refusals.

Tolerances. f32 on both sides, apart by the order of the sums only: loss
1e-6 relative (reading 9.5e-7 at losses near 4.5: two f32 ulps), ``dx``
and ``dw`` 1e-7 abs (readings 9.3e-9 and 3.0e-8; gradients are below
0.05). Chunked against dense in the port: loss 1e-6 relative (reading
0), gradients 1e-7 abs (reading 2.2e-8). bf16 inputs: the chunk logits
are the same f32 products of bf16 values in both packages, and ``dx`` and
``dw`` round the same f32 sums to bf16 once, so an element may land one
bf16 ulp apart: 1e-6 + 2^-7 of |JAX| (reading 0: identical); the losses
1e-5 abs (reading 9.5e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.chunked_ce import chunked_causal_lm_loss as jax_chunked
from paddle_tpu_torch.ops.chunked_ce import (NEG, _num_chunks,
                                             chunked_causal_lm_loss)

B, S, H = 2, 16, 32


def _inputs(V, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H)).astype(dtype),
            (rng.standard_normal((V, H)) * 0.3).astype(dtype),
            rng.integers(0, V, (B, S)).astype(np.int32))


def _jax(x, w, lbl, chunk, dtype=jnp.float32):
    loss, (dx, dw) = jax.value_and_grad(
        lambda a, b: jax_chunked(a, b, jnp.asarray(lbl), chunk),
        argnums=(0, 1))(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    return (float(loss), np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _port(x, w, lbl, chunk, dtype=torch.float32):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    wt = torch.tensor(w, dtype=dtype, requires_grad=True)
    loss = chunked_causal_lm_loss(xt, wt, torch.from_numpy(lbl), chunk)
    dx, dw = torch.autograd.grad(loss, (xt, wt))
    assert dx.dtype == dtype and dw.dtype == dtype
    return float(loss.detach()), dx.float().numpy(), dw.float().numpy()


# (V, chunk): the chunk divides V, does not (a padded last chunk), is
# larger than V (one padded chunk) and equals it; 211 / 48 is the long
# context example's CPU shape
SHAPES = [(96, 32), (101, 32), (101, 128), (96, 96), (211, 48)]


@pytest.mark.parametrize("V,chunk", SHAPES)
def test_loss_and_grads_match_jax(V, chunk):
    x, w, lbl = _inputs(V)
    want = _jax(x, w, lbl, chunk)
    got = _port(x, w, lbl, chunk)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for name, a, b in zip(("dx", "dw"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=0, err_msg=name)


def _dense(xt, wt, lbl):
    """The dense f32 loss: every logit, log-softmax, mean NLL."""
    logp = torch.log_softmax((xt @ wt.T).to(torch.float32), -1)
    return -logp.gather(-1, lbl.long()[..., None]).mean()


@pytest.mark.parametrize("V,chunk", SHAPES)
def test_chunked_matches_the_dense_loss(V, chunk):
    x, w, lbl = _inputs(V, seed=1)
    got = _port(x, w, lbl, chunk)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = _dense(xt, wt, torch.from_numpy(lbl))
    dx, dw = torch.autograd.grad(loss, (xt, wt))
    np.testing.assert_allclose(got[0], float(loss.detach()), rtol=1e-6)
    np.testing.assert_allclose(got[1], dx.numpy(), atol=1e-7, rtol=0)
    np.testing.assert_allclose(got[2], dw.numpy(), atol=1e-7, rtol=0)


@pytest.mark.parametrize("V,chunk", [(64, 32), (101, 32)])
def test_bf16_inputs_match_jax(V, chunk):
    x, w, lbl = _inputs(V, seed=2)
    want = _jax(x, w, lbl, chunk, jnp.bfloat16)
    got = _port(x, w, lbl, chunk, torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    for name, a, b in zip(("dx", "dw"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=2 ** -7,
                                   err_msg=name)


def test_chunk_count_and_pad_mask():
    assert [_num_chunks(V, c) for V, c in SHAPES] == [3, 4, 1, 1, 5]
    # a label in the padded columns' range never exists; a vocabulary of
    # one chunk padded to 128 gives the loss of its 101 real columns
    x, w, lbl = _inputs(101, seed=3)
    padded = _port(x, w, lbl, 128)[0]
    exact = _port(x, w, lbl, 101)[0]
    np.testing.assert_allclose(padded, exact, rtol=1e-6)
    assert NEG == -1e30


def test_refuses_bad_shapes():
    x, w, lbl = (torch.from_numpy(a) for a in _inputs(32))
    with pytest.raises(ValueError, match="expected x"):
        chunked_causal_lm_loss(x[0], w, lbl, 16)
    with pytest.raises(ValueError, match="expected x"):
        chunked_causal_lm_loss(x, w[:, :-1], lbl, 16)
    with pytest.raises(ValueError, match="expected x"):
        chunked_causal_lm_loss(x, w, lbl[:, :-1], 16)
    with pytest.raises(ValueError, match="chunk_size"):
        chunked_causal_lm_loss(x, w, lbl, 0)
