"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs an NVIDIA GPU and nvcc: it carries the
``cuda`` marker and skips without a card. This file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import importlib

import numpy as np
import pytest
import torch

# the package re-exports the function under the module's name
tpa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _pools(kv, Hkv, P, ps, D, dev, rng):
    if kv == "int8":
        kp = torch.from_numpy(rng.integers(-127, 128, (Hkv, P, ps, D))
                              .astype(np.int8)).to(dev)
        vp = torch.from_numpy(rng.integers(-127, 128, (Hkv, P, ps, D))
                              .astype(np.int8)).to(dev)
        sc = {"k_scales": torch.rand((Hkv, P, ps), device=dev) * 0.02,
              "v_scales": torch.rand((Hkv, P, ps), device=dev) * 0.02}
        return kp, vp, sc
    dt = getattr(torch, kv)
    return (torch.randn((Hkv, P, ps, D), device=dev).to(dt),
            torch.randn((Hkv, P, ps, D), device=dev).to(dt), {})


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv,D", [("bfloat16", "bfloat16", 128),
                                          ("bfloat16", "int8", 128),
                                          ("float32", "float32", 128),
                                          ("float32", "bfloat16", 64),
                                          ("bfloat16", "float32", 64)])
def test_paged_kernel_matches_plain(card, q_dtype, kv, D):
    """Decode (a pad row of length 0 gives exact zeros) and a 256-token
    chunk at start 256. Tolerance: 1e-4 + 2^-7·|want| for a bf16 output
    (both round an f32 sum, apart by its order only, to bf16 once: one
    bf16 ulp at most), 1e-5 for an f32 output."""
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    B, Hkv, G, P, ps, W = 4, 2, 4, 40, 64, 8
    dt = getattr(torch, q_dtype)
    kp, vp, sc = _pools(kv, Hkv, P, ps, D, card, rng)
    pt = torch.from_numpy(np.stack([rng.choice(np.arange(1, P), W, False)
                                    for _ in range(B)]).astype(np.int32)
                          ).to(card)
    sl = torch.tensor([1, 100, 512, 0], dtype=torch.int32, device=card)
    atol, rtol = (1e-4, 2 ** -7) if dt == torch.bfloat16 else (1e-5, 1e-5)
    q = torch.randn((B, Hkv * G, D), device=card).to(dt)
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(q, kp, vp, pt, sl, **sc)
    want = tpa.paged_attention_reference(q, kp, vp, pt, sl, **sc)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert not got[3].any()
    qc = torch.randn((1, Hkv * G, 256, D), device=card).to(dt)
    lens = torch.tensor([400], dtype=torch.int32, device=card)
    got = tpa.paged_prefill_attention(qc, kp, vp, pt[:1], lens, 256, **sc)
    want = tpa.paged_attention_reference(qc, kp, vp, pt[:1], lens, **sc,
                                         q_start=256)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_paged_kernel_takes_int64_tables(card):
    """int64 tables and lengths are converted, not refused."""
    rng = np.random.default_rng(1)
    kp, vp, _ = _pools("bfloat16", 2, 10, 64, 128, card, rng)
    q = torch.randn((2, 4, 128), device=card).to(torch.bfloat16)
    pt = torch.tensor([[1, 2], [3, 4]], device=card)
    sl = torch.tensor([70, 5], device=card)
    got = tpa.paged_attention(q, kp, vp, pt, sl)
    want = tpa.paged_attention_reference(q, kp, vp, pt, sl)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2 ** -7)


@pytest.mark.cuda
def test_paged_kernel_refuses_what_it_does_not_take(card):
    rng = np.random.default_rng(2)
    kp, vp, _ = _pools("bfloat16", 2, 10, 64, 96, card, rng)
    q = torch.randn((1, 4, 96), device=card).to(torch.bfloat16)
    pt = torch.ones((1, 2), dtype=torch.int32, device=card)
    sl = torch.tensor([3], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim 96"):
        tpa.paged_attention(q, kp, vp, pt, sl)
    kp, vp, _ = _pools("bfloat16", 2, 10, 64, 128, card, rng)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_attention(q.new_zeros((1, 4, 128)),
                            kp.transpose(2, 3).contiguous().transpose(2, 3),
                            vp, pt, sl)
