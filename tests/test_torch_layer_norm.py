"""The port's ``fused_layer_norm`` and ``fused_rms_norm`` (their plain
versions, which CPU tensors take) against the JAX package's Pallas
kernels run as its own tests run them on the CPU (interpret mode). Same
numpy inputs: odd row counts and widths, and BERT's eps of 1e-12.

Tolerances. float32: both sides take f32 statistics and differ only in
the order of the row sums: 1e-5 absolute and relative. bfloat16: the same
f32 values rounded to bfloat16 once, so an element may land one bf16 ulp
apart, at most 2^-7 of its size (1e-5 absolute near 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.layer_norm import fused_layer_norm as jax_ln
from paddle_tpu.ops.pallas.layer_norm import fused_rms_norm as jax_rms
from paddle_tpu_torch.ops import fused_layer_norm, fused_rms_norm

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7)}
SHAPES = [(64, 128), (7, 100), (3, 5, 33), (16, 768)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    H = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(H).astype(np.float32)
    b = rng.standard_normal(H).astype(np.float32)
    return x, w, b


def _to(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("dtype,wdtype", [("float32", "float32"),
                                          ("bfloat16", "bfloat16"),
                                          ("bfloat16", "float32")])
def test_layer_norm_matches_jax(shape, eps, dtype, wdtype):
    x, w, b = _inputs(shape, seed=len(shape) + shape[-1])
    jd, jw = getattr(jnp, dtype), getattr(jnp, wdtype)
    want = jax_ln(jnp.asarray(x, jd), jnp.asarray(w, jw), jnp.asarray(b, jw),
                  eps=eps)
    got = fused_layer_norm(_to(x, dtype), _to(w, wdtype), _to(b, wdtype),
                           eps)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("eps", [1e-6, 1e-12])
@pytest.mark.parametrize("dtype,wdtype", [("float32", "float32"),
                                          ("bfloat16", "bfloat16"),
                                          ("bfloat16", "float32")])
def test_rms_norm_matches_jax(shape, eps, dtype, wdtype):
    x, w, _ = _inputs(shape, seed=2 * shape[-1])
    jd, jw = getattr(jnp, dtype), getattr(jnp, wdtype)
    want = jax_rms(jnp.asarray(x, jd), jnp.asarray(w, jw), eps=eps)
    got = fused_rms_norm(_to(x, dtype), _to(w, wdtype), eps)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    _close(got, want, dtype)


def test_norms_refuse_a_gradient_and_count_no_launch_on_the_cpu():
    """Forward only, as the reference; the CPU runs no kernel."""
    x = torch.randn(4, 16, requires_grad=True)
    w, b = torch.ones(16), torch.zeros(16)
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_layer_norm(x, w, b)
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_rms_norm(x, w)
    before = (fused_layer_norm.launches, fused_rms_norm.launches)
    with torch.no_grad():
        fused_layer_norm(x, w, b)
        fused_rms_norm(x, w)
    assert (fused_layer_norm.launches, fused_rms_norm.launches) == before
    with pytest.raises(ValueError, match=r"\(16,\)"):
        fused_rms_norm(x.detach(), torch.ones(15))
