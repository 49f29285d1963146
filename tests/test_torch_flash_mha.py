"""The port's multi-head ``flash_attention`` (its plain path, through the
same ``torch.autograd.Function`` the card uses) against the JAX package's
``flash_attention`` run as the JAX package's own tests run it on the CPU
(Pallas interpret mode), in both of its modes: K/V resident
(``stream=False``: ``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel``) and K/V streamed (``stream=True``: the ``_stream``
kernels). Same numpy inputs; forward out and lse, and dq/dk/dv through
``jax.vjp`` against ``backward``; Sq = Sk and Sq != Sk (top-left causal).

Tolerances, as for the grouped kernels (``test_torch_flash_gqa.py``).
float32: both sides sum in f32 and differ only in order: out and lse
within 1e-5 (reading 4.8e-7), gradients within 1e-4 (reading 2.1e-6).
bfloat16: the same roundings (q2, probabilities and ds to bf16) on f32
sums whose order differs, so an element may land one bf16 ulp apart:
|err| <= 1e-3 + 2^-7·|want| (readings: err/limit 0.66 for out, 0.72 for
the gradients); lse is f32 on both sides, within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import (_flash_fwd,
                                                   _flash_fwd_stream,
                                                   _resolve_blocks)
from paddle_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash
from paddle_tpu_torch.ops.flash_attention import flash_attention
from paddle_tpu_torch.ops.flash_attention_gqa import _gqa_fwd_plain

B, H, D = 1, 2, 64
TOL = {"float32": dict(out=(1e-5, 0.0), grad=(1e-4, 0.0)),
       "bfloat16": dict(out=(1e-3, 2 ** -7), grad=(1e-3, 2 ** -7))}


def _inputs(Sq, Sk, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    do = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    return q, k, v, do


def _close(got, want, atol, rtol):
    got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("Sq,Sk", [(256, 256), (256, 512), (512, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_flash_matches_jax(dtype, causal, Sq, Sk, stream):
    q, k, v, do = _inputs(Sq, Sk, seed=Sq + Sk)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jd) for a in (q, k, v, do))
    scale = 1 / np.sqrt(D)
    bq, bk, streamed = _resolve_blocks(Sq, Sk, None, None, D,
                                       jq.dtype.itemsize, stream)
    assert streamed == stream
    j_fwd = _flash_fwd_stream if stream else _flash_fwd
    j_out, j_lse = j_fwd(jq, jk, jv, causal, scale, bq, bk)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal,
                                               stream=stream), jq, jk, jv)
    j_grads = vjp(jdo)

    tq, tk, tv = (torch.from_numpy(a).to(td).requires_grad_()
                  for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal)
    out.backward(torch.from_numpy(do).to(td))
    _, lse = _gqa_fwd_plain(tq.detach(), tk.detach(), tv.detach(), causal)

    tol = TOL[dtype]
    _close(out, j_out, *tol["out"])
    _close(lse, j_lse, 1e-5, 0.0)
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        assert got.dtype == td
        _close(got, want, *tol["grad"])


def test_mha_flash_refuses_a_head_count_mismatch():
    q = torch.zeros((1, 4, 256, 64))
    k = torch.zeros((1, 2, 256, 64))
    with pytest.raises(ValueError, match="one head count"):
        flash_attention(q, k, k)


def test_mha_flash_counts_no_launch_on_the_cpu():
    """On the CPU the plain version runs: no kernel, no launch counted."""
    q = torch.randn((1, 2, 256, 64), requires_grad=True)
    before = (flash_attention.launches_fwd, flash_attention.launches_dq,
              flash_attention.launches_dkv)
    flash_attention(q, q, q, True).sum().backward()
    assert (flash_attention.launches_fwd, flash_attention.launches_dq,
            flash_attention.launches_dkv) == before
