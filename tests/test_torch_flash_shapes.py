"""The attention shapes the port's kernels used to refuse on the card,
checked on the CPU against the JAX package: head_dim 256, kv groups that
do not divide the kernels' row tile (64 rows in bfloat16 and float16, 32
in float32) and float16.

* grouped flash attention (the port's plain path, through the same
  ``torch.autograd.Function`` the card uses) against the reference's
  ``_gqa_fwd_impl`` and ``grouped_flash_attention`` run as the JAX
  package's own tests run them on the CPU (Pallas interpret mode): out,
  lse, and dq/dk/dv through ``jax.vjp`` against ``backward``;
* splash attention at G = 3 on the sliding-window band, the same way;
* ``scaled_dot_product_attention`` on float16 tensors at a flash-eligible
  shape (the reference takes its flash kernel there and returns float16);
* the paged decode at head_dim 256 against the reference's Pallas kernel;
* the kernels' own operand checks (``_operands``, ``_bwd_operands``, the
  paged ``_kernel_operands``), on CPU tensors, accept every (S, D, G,
  dtype) the flash gates admit, so a CUDA tensor of such a shape reaches
  its kernel.

Tolerances. float32: both sides sum in f32 and differ only in order: out
and lse within 1e-5, gradients within 1e-4. bfloat16: the same roundings
(q2, probabilities and ds to bf16) on f32 sums in another order; the
reference rounds each probability against the running max, the plain
version against the final one, so an output element may land two bf16
ulps apart: 1e-3 + 2^-6·|want|; a gradient adds the output's difference
carried through delta = rowsum(do·out) into ds = p·(dp - delta), where
dp - delta cancels: 4e-3 + 2^-6·|want| (as tests/test_torch_splash.py).
float16: the same roundings to f16, whose ulp is 2^-10 relative, 8 times
finer than bf16's: 2e-4 + 2^-9·|want| for out, 5e-4 + 2^-9·|want| for
the gradients.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import splash_attention as jsplash
from paddle_tpu.ops.pallas.flash_attention_gqa import (
    _gqa_fwd_impl, _gqa_resolve_blocks, grouped_flash_attention as jax_gfa)
from paddle_tpu_torch.nn.functional.attention import (
    _flash_gate, scaled_dot_product_attention)
from paddle_tpu_torch.ops import flash_attention as tflash
from paddle_tpu_torch.ops import flash_attention_gqa as tgqa
from paddle_tpu_torch.ops import splash_attention as tsplash

jpa = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")
tpa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")

TOL = {"float32": dict(out=(1e-5, 0.0), grad=(1e-4, 0.0)),
       "bfloat16": dict(out=(1e-3, 2 ** -6), grad=(4e-3, 2 ** -6)),
       "float16": dict(out=(2e-4, 2 ** -9), grad=(5e-4, 2 ** -9))}


def _inputs(Hkv, G, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, Hkv * G, Sq, D)).astype(np.float32)
    k = rng.standard_normal((1, Hkv, Sk, D)).astype(np.float32)
    v = rng.standard_normal((1, Hkv, Sk, D)).astype(np.float32)
    do = rng.standard_normal((1, Hkv * G, Sq, D)).astype(np.float32)
    return q, k, v, do


def _close(got, want, atol, rtol):
    got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want,
                                                           jnp.float32)),
                               atol=atol, rtol=rtol)


# (name, dtype, Hkv, G, D, causal): kv groups of 3 and 6 (one query head
# a tile on the card), head_dim 256 at G = 1 and 2, and float16
GROUPED_CASES = [
    ("g3_bf16", "bfloat16", 2, 3, 64, True),
    ("g6_f32", "float32", 1, 6, 64, False),
    ("g6_bf16", "bfloat16", 1, 6, 128, True),
    ("d256_g1_f32", "float32", 1, 1, 256, True),
    ("d256_g2_bf16", "bfloat16", 1, 2, 256, True),
    ("f16_g1", "float16", 2, 1, 128, True),
    ("f16_g2_noncausal", "float16", 1, 2, 64, False),
    ("f16_g3_d256", "float16", 1, 3, 256, True),
]


@pytest.mark.parametrize("case", GROUPED_CASES,
                         ids=[c[0] for c in GROUPED_CASES])
def test_grouped_flash_shapes_match_jax(case):
    _, dtype, Hkv, G, D, causal = case
    S = 256
    q, k, v, do = _inputs(Hkv, G, S, S, D, seed=G + D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jd) for a in (q, k, v, do))
    bq, bk = _gqa_resolve_blocks(S, S, G, None, None, D, jq.dtype.itemsize)
    j_out, j_lse = _gqa_fwd_impl(jq, jk, jv, causal, 1 / np.sqrt(D), bq, bk)
    _, vjp = jax.vjp(lambda a, b, c: jax_gfa(a, b, c, causal), jq, jk, jv)
    j_grads = vjp(jdo)

    tq, tk, tv = (torch.from_numpy(a).to(td).requires_grad_()
                  for a in (q, k, v))
    out = tgqa.grouped_flash_attention(tq, tk, tv, causal)
    out.backward(torch.from_numpy(do).to(td))
    _, lse = tgqa._gqa_fwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                 causal)
    tol = TOL[dtype]
    assert out.dtype == td and j_out.dtype == jd
    _close(out, j_out, *tol["out"])
    _close(lse, j_lse, 1e-5, 0.0)
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        assert got.dtype == td
        _close(got, want, *tol["grad"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_splash_g3_band_matches_jax(dtype):
    """G = 3 over the sliding-window band (window 100, 64-blocks)."""
    G, S, D, window = 3, 256, 64, 100
    bm = jsplash.banded_block_mask(S, S, 64, 64, window)
    q, k, v, do = _inputs(2, G, S, S, D, seed=7)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jd) for a in (q, k, v, do))

    j_out, vjp = jax.vjp(lambda a, b, c: jsplash.splash_attention(
        a, b, c, bm, True, None, 64, 64, window, 0), jq, jk, jv)
    j_grads = vjp(jdo)
    tq, tk, tv = (torch.from_numpy(a).to(td).requires_grad_()
                  for a in (q, k, v))
    out = tsplash.splash_attention(tq, tk, tv, bm, True, None, 64, 64,
                                   window)
    out.backward(torch.from_numpy(do).to(td))
    tol = TOL[dtype]
    _close(out, j_out, *tol["out"])
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        _close(got, want, *tol["grad"])


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_float16_matches_the_reference(causal, monkeypatch):
    """float16 at a flash-eligible shape: both take their flash path
    (the gate reads no dtype) and return float16."""
    import paddle_tpu as paddle
    from paddle_tpu.nn.functional.attention import \
        scaled_dot_product_attention as jsdpa

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 256, 2, 64)).astype(np.float16)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    assert _flash_gate(tq, tk, None)
    calls = []
    mha_fwd = tflash.mha_fwd
    monkeypatch.setattr(tflash, "mha_fwd",
                        lambda *a: calls.append(a[0].dtype) or mha_fwd(*a))
    got = scaled_dot_product_attention(tq, tk, tv, is_causal=causal)
    want = jsdpa(paddle.to_tensor(q), paddle.to_tensor(k),
                 paddle.to_tensor(v), is_causal=causal)
    assert got.dtype == torch.float16 and str(want.dtype) == "float16"
    assert calls == [torch.float16]     # the flash entry point's forward
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.numpy(), np.float32),
                               atol=2e-4, rtol=2 ** -9)


@pytest.mark.parametrize("G", [1, 3])
def test_paged_decode_d256_matches_pallas_kernel(G):
    """Decode at head_dim 256, ragged lengths and a pad row of length 0
    (exactly 0), f32: the order of the sums only."""
    rng = np.random.default_rng(G)
    B, Hkv, D, P, ps, W = 4, 2, 256, 12, 8, 4
    q = rng.normal(0, 1, (B, Hkv * G, D)).astype(np.float32)
    kp, vp = (rng.normal(0, 1, (Hkv, P, ps, D)).astype(np.float32)
              for _ in range(2))
    pt = np.stack([rng.choice(np.arange(1, P), W, replace=False)
                   for _ in range(B)]).astype(np.int32)
    sl = np.asarray([13, 32, 1, 0], np.int32)
    want = np.asarray(jpa.paged_attention(*(jnp.asarray(a) for a in
                                            (q, kp, vp, pt, sl))))
    got = tpa.paged_attention(*(torch.from_numpy(a) for a in
                                (q, kp, vp, pt, sl))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert not np.any(got[3])


# every length the gates admit up to 1024 (>= 256, a multiple of 128),
# and every kv group up to 8 beside the large powers of two
GATE_LENGTHS = [256, 384, 512, 640, 768, 896, 1024]
GATE_GROUPS = [1, 2, 3, 4, 5, 6, 7, 8, 16, 32, 64]


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_operands_accept_every_admitted_shape(dtype, D):
    """What ``flash_eligible`` (float32, bfloat16) and ``_flash_gate``
    (any dtype the reference's kernel runs: float16 too) admit, the
    kernels' operand checks take, forward and backward, Sq == Sk and
    Sq != Sk."""
    dt = getattr(torch, dtype)
    for S in GATE_LENGTHS:
        for Sk in (S, 2 * S):
            q = torch.zeros((1, 1, S, D), dtype=dt)
            k = torch.zeros((1, 1, Sk, D), dtype=dt)
            assert _flash_gate(q.transpose(1, 2), k.transpose(1, 2), None)
            if dtype != "float16":
                assert tflash.flash_eligible(S, D, dt)
            for G in GATE_GROUPS:
                qg = q.expand(1, G, S, D)
                shape, _ = tgqa._operands("check", [qg, k, k], qg, k, k)
                assert shape == (1, 1, G, S, Sk, D)
                lse = torch.zeros((1, G, S))
                tgqa._bwd_operands(qg, k, k, qg, lse, lse)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_operands_accept_every_admitted_head_dim(dtype, D):
    """The paged kernel's operand checks take every head_dim the flash
    gate admits, for every kv group, in decode and in a prefill chunk."""
    dt = getattr(torch, dtype)
    kp = torch.zeros((2, 5, 16, D), dtype=dt)
    pt = torch.ones((1, 4), dtype=torch.int32)
    n = torch.ones((1,), dtype=torch.int32)
    for G in GATE_GROUPS:
        for rows in (G, G * 256):        # decode, a 256-token chunk
            q4 = torch.zeros((1, 2, rows, D), dtype=dt)
            got = tpa._kernel_operands(q4, kp, kp, pt, n, n, None, None)
            assert got[0].shape == q4.shape


def test_kernel_operands_refuse_what_no_kernel_takes():
    """What the gates refuse stays refused by the kernels' checks."""
    q = torch.zeros((1, 2, 256, 96))
    with pytest.raises(ValueError, match="head_dim 96"):
        tgqa._operands("check", [q, q, q], q, q, q)
    q = torch.zeros((1, 2, 256, 64), dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        tgqa._operands("check", [q, q, q], q, q, q)
    q = torch.zeros((1, 3, 250, 64))
    k = torch.zeros((1, 1, 250, 64))
    with pytest.raises(ValueError, match="multiples"):
        tgqa._operands("check", [q, k, k], q, k, k)
    kp = torch.zeros((2, 5, 16, 96))
    with pytest.raises(ValueError, match="head_dim 96"):
        tpa._kernel_operands(torch.zeros((1, 2, 1, 96)), kp, kp,
                             torch.ones((1, 4), dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32), None, None)
