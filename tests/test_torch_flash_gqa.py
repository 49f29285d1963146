"""The port's grouped flash attention (its plain path, through the same
``torch.autograd.Function`` the card uses) against the JAX package's
``grouped_flash_attention`` run as the JAX package's own tests run it on
the CPU (Pallas interpret mode), on the same numpy inputs: forward out and
lse, and dq/dk/dv through ``jax.vjp`` against ``backward``.

Tolerances. float32: both sides sum in f32 and differ only in order:
out and lse within 1e-5 (readings up to 1e-6), gradients within 1e-4
(readings up to 4e-6). bfloat16: both sides make the same roundings
(q2, probabilities and ds to bf16) on f32 sums whose order differs, so an
output element may land one bf16 ulp apart: |err| <= 1e-3 + 2^-7·|want|
(readings: one ulp at most, 7.8e-3 at |want| near 4); lse is f32 on both
sides, within 1e-5.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention_gqa import (
    _gqa_fwd_impl, _gqa_resolve_blocks, grouped_flash_attention as jax_gfa)
from paddle_tpu_torch.ops import flash_attention as tflash
from paddle_tpu_torch.ops.flash_attention_gqa import (_gqa_fwd_plain,
                                                      grouped_flash_attention)

B, HKV, S, D = 2, 2, 256, 64
TOL = {"float32": dict(out=(1e-5, 0.0), grad=(1e-4, 0.0)),
       "bfloat16": dict(out=(1e-3, 2 ** -7), grad=(1e-3, 2 ** -7))}


def _inputs(G, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV * G, S, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    do = rng.standard_normal((B, HKV * G, S, D)).astype(np.float32)
    return q, k, v, do


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, atol, rtol):
    got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, _np(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_grouped_flash_matches_jax(dtype, G, causal):
    q, k, v, do = _inputs(G)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jd) for a in (q, k, v, do))
    bq, bk = _gqa_resolve_blocks(S, S, G, None, None, D, jq.dtype.itemsize)
    j_out, j_lse = _gqa_fwd_impl(jq, jk, jv, causal, 1 / np.sqrt(D), bq, bk)
    _, vjp = jax.vjp(lambda a, b, c: jax_gfa(a, b, c, causal), jq, jk, jv)
    j_grads = vjp(jdo)

    tq, tk, tv = (torch.from_numpy(a).to(td).requires_grad_()
                  for a in (q, k, v))
    out = grouped_flash_attention(tq, tk, tv, causal)
    out.backward(torch.from_numpy(do).to(td))
    _, lse = _gqa_fwd_plain(tq.detach(), tk.detach(), tv.detach(), causal)

    tol = TOL[dtype]
    _close(out, j_out, *tol["out"])
    _close(lse, j_lse, 1e-5, 0.0)
    assert lse.dtype == torch.float32 and lse.shape == (B, HKV * G, S)
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        assert got.dtype == td
        _close(got, want, *tol["grad"])
    assert tk.grad.shape == (B, HKV, S, D)       # the true kv head count


def test_head_count_mismatch_raises():
    q = torch.zeros((1, 3, 256, 64))
    k = torch.zeros((1, 2, 256, 64))
    with pytest.raises(ValueError, match="not a multiple"):
        grouped_flash_attention(q, k, k)


def test_flash_gate_matches_the_reference():
    """The port's copy of ``flash_eligible`` and its constants."""
    # the JAX package re-exports a function under the module's name
    jflash = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    for S, hd, dt in [(256, 64, "float32"), (128, 64, "float32"),
                      (384, 128, "bfloat16"), (300, 128, "bfloat16"),
                      (512, 96, "float32"), (512, 256, "float16")]:
        assert tflash.flash_eligible(S, hd, getattr(torch, dt)) == \
            jflash.flash_eligible(S, hd, getattr(jnp, dt))
    assert (tflash.NEG_INF, tflash.LOG2E, tflash.LN2) == \
        (jflash.NEG_INF, jflash.LOG2E, jflash.LN2)
