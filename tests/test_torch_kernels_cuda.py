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


# --- grouped flash attention (forward, dq, dkv) -----------------------------

fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention_gqa")
ce = importlib.import_module("paddle_tpu_torch.ops.fused_ce")

# kernel vs plain on the same inputs. float32: f32 sums in another order
# (CUDA cores against cuBLAS in full f32). bfloat16: the same roundings on
# f32 sums in another order, plus the forward's online softmax, which rounds
# each probability against the running max rather than the final one: an
# element may land a bf16 ulp or two apart.
GQA_TOL = {torch.float32: dict(out=(1e-5, 1e-5), grad=(1e-4, 1e-4)),
           torch.bfloat16: dict(out=(2e-3, 2 ** -6), grad=(2e-3, 2 ** -6))}
# the autograd path end to end: the backward of the kernel's own forward
# (its out and lse) against the plain backward of the plain forward, as
# ||g_kernel - g_plain|| / ||g_plain||
GQA_GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _gqa_inputs(B, Hkv, G, S, D, dt, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Hkv * G, S, D), generator=g, device=dev).to(dt)
    k = torch.randn((B, Hkv, S, D), generator=g, device=dev).to(dt)
    v = torch.randn((B, Hkv, S, D), generator=g, device=dev).to(dt)
    do = torch.randn((B, Hkv * G, S, D), generator=g, device=dev).to(dt)
    return q, k, v, do


def _reading(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    ratio = float((err / (atol + rtol * want.float().abs())).max())
    print(f"reading {name}: max abs err {float(err.max()):.3g}, err/limit "
          f"{ratio:.3f}")
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _rel(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dt,D,G,S,causal",
                         [(torch.bfloat16, 128, 4, 1024, True),
                          (torch.bfloat16, 64, 8, 256, False),
                          (torch.bfloat16, 128, 2, 512, False),
                          (torch.float32, 64, 2, 256, True),
                          (torch.float32, 128, 4, 256, False)])
def test_gqa_kernels_match_plain(card, dt, D, G, S, causal):
    """The forward kernel (out, lse), then the dq and dkv kernels on the
    plain forward's residuals, each against its plain version element by
    element; then the autograd Function end to end (each kernel launched
    once), as relative gradient norms."""
    q, k, v, do = _gqa_inputs(2, 2, G, S, D, dt, card, seed=S + D)
    tol = GQA_TOL[dt]
    gfa = fa.grouped_flash_attention
    out, lse = fa.gqa_fwd(q, k, v, causal)
    want_out, want_lse = fa._gqa_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    _reading("out", out, want_out, *tol["out"])
    _reading("lse", lse, want_lse, 1e-5, 1e-5)
    delta = (do.float() * want_out.float()).sum(-1)
    got = fa.gqa_bwd(q, k, v, do, want_lse, delta, causal)
    want = fa._gqa_bwd_plain(q, k, v, do, want_lse, delta, causal)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt and g.shape == w.shape
        _reading(name, g, w, *tol["grad"])

    launches = (gfa.launches_fwd, gfa.launches_dq, gfa.launches_dkv)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    gfa(qg, kg, vg, causal).backward(do)
    torch.cuda.synchronize()
    assert (gfa.launches_fwd, gfa.launches_dq, gfa.launches_dkv) == \
        (launches[0] + 1, launches[1] + 1, launches[2] + 1)
    for name, g, w in zip(("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad),
                          want):
        rel = _rel(g, w)
        print(f"reading autograd {name}: relative norm error {rel:.3g}")
        assert rel <= GQA_GRAD_REL[dt]


@pytest.mark.cuda
def test_gqa_kernels_refuse_what_they_do_not_take(card):
    q, k, v, _ = _gqa_inputs(1, 2, 2, 256, 96, torch.bfloat16, card, 1)
    with pytest.raises(ValueError, match="head_dim 96"):
        fa.grouped_flash_attention(q, k, v, True)
    q, k, v, _ = _gqa_inputs(1, 2, 2, 256, 64, torch.float16, card, 2)
    with pytest.raises(TypeError, match="float16"):
        fa.grouped_flash_attention(q, k, v, True)
    q, k, v, _ = _gqa_inputs(1, 2, 2, 256, 64, torch.bfloat16, card, 3)
    with pytest.raises(ValueError, match="not a multiple"):
        fa.grouped_flash_attention(q[:, :3], k, v, True)
    with pytest.raises(TypeError, match="share one dtype"):
        fa.grouped_flash_attention(q, k.float(), v, True)


@pytest.mark.cuda
def test_bf16_train_grads_are_as_close_to_f32_as_the_plain_versions(
        card, monkeypatch):
    """A bf16 GQA Llama (hidden 1024, 8 / 2 heads, head_dim 128, 4 layers,
    vocab 4096, B=2, S=1024): the loss gradients through the kernels and
    through their plain versions, each against the same weights in f32
    through the plain versions (the truth). bf16 roundings put both some
    distance from the truth; the kernels may not be further from it than
    the plain versions by more than a tenth, for the worst parameter and
    for the median one. Readings: relative errors 0.01426 / 0.01158
    (kernels, worst / median) against 0.01430 / 0.01159 (plain)."""
    import dataclasses
    import statistics

    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             param_views)
    from paddle_tpu_torch.models.nlp.llama_functional import loss_fn

    cfg = dataclasses.replace(
        LlamaConfig.tiny(vocab=4096, hidden=1024, layers=4, heads=8,
                         kv_heads=2), dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=card, seed=0)
    rng = np.random.default_rng(0)
    tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (2, 1024))).to(card)
                      for _ in range(2))

    def grads(params, plain):
        with monkeypatch.context() as m:
            if plain:
                m.setattr(fa, "gqa_fwd", fa._gqa_fwd_plain)
                m.setattr(fa, "gqa_bwd", fa._gqa_bwd_plain)
                m.setattr(ce, "ce_fwd", ce._ce_fwd_plain)
                m.setattr(ce, "ce_bwd", ce._ce_bwd_plain)
            outer, layers = param_views(params, cfg.num_hidden_layers)
            loss = loss_fn(cfg, outer, layers, tokens, labels, remat=False)
            return torch.autograd.grad(loss, list(params.values()))

    bf = {k: p.detach().requires_grad_() for k, p in
          model.named_parameters()}
    f32 = {k: p.detach().float().requires_grad_() for k, p in bf.items()}
    launches = ce.softmax_cross_entropy.launches_bwd
    g_kernel = grads(bf, plain=False)
    assert ce.softmax_cross_entropy.launches_bwd == launches + 1
    g_plain = grads(bf, plain=True)
    g_true = grads(f32, plain=True)
    kernel = [_rel(a, t) for a, t in zip(g_kernel, g_true)]
    plain = [_rel(a, t) for a, t in zip(g_plain, g_true)]
    print(f"reading vs f32: kernels max {max(kernel):.4g} median "
          f"{statistics.median(kernel):.4g}; plain max {max(plain):.4g} "
          f"median {statistics.median(plain):.4g}")
    assert max(kernel) <= 1.1 * max(plain)
    assert statistics.median(kernel) <= 1.1 * statistics.median(plain)


@pytest.mark.cuda
def test_mha_at_flash_shapes_refuses_on_the_card(card):
    """kv_heads == heads at a flash-eligible length needs the multi-head
    flash kernels, which are not ported: the card raises rather than
    taking the dense path."""
    from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM

    model = LlamaForCausalLM(LlamaConfig.tiny(hidden=256, heads=4,
                                              kv_heads=4), device=card)
    with pytest.raises(NotImplementedError, match="rows 2-5"):
        model(torch.zeros((1, 256), dtype=torch.long, device=card))


# --- fused cross-entropy (forward, backward) ---------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dt,N,V", [(torch.bfloat16, 64, 128256),
                                    (torch.float32, 100, 1000),
                                    (torch.bfloat16, 33, 1001)])
def test_fused_ce_kernels_match_plain(card, dt, N, V):
    """loss/lse within 1e-5·(1 + |want|) (f32, sums in another order); dx
    within 1e-6 + one bf16 ulp (2^-7·|want|), or 1e-6 in f32. V = 1001 is
    not a multiple of 8: the scalar-load path."""
    g = torch.Generator(device=card).manual_seed(N)
    x = (torch.randn((N, V), generator=g, device=card) * 3).to(dt)
    lbl = torch.randint(0, V, (N,), generator=g, device=card)
    lbl[1], lbl[5] = V + 3, -2                  # outside [0, V)
    gr = torch.rand((N,), generator=g, device=card) + 0.5
    before = (ce.softmax_cross_entropy.launches_fwd,
              ce.softmax_cross_entropy.launches_bwd)
    loss, lse = ce.ce_fwd(x, lbl)
    dx = ce.ce_bwd(x, lbl, lse, gr)
    want_loss, want_lse = ce._ce_fwd_plain(x, lbl)
    want_dx = ce._ce_bwd_plain(x, lbl, want_lse, gr)
    torch.cuda.synchronize()
    assert (ce.softmax_cross_entropy.launches_fwd,
            ce.softmax_cross_entropy.launches_bwd) == \
        (before[0] + 1, before[1] + 1)
    _reading("loss", loss, want_loss, 1e-5, 1e-5)
    _reading("lse", lse, want_lse, 1e-5, 1e-5)
    assert dx.dtype == dt
    _reading("dx", dx, want_dx, 1e-6,
             2 ** -7 if dt == torch.bfloat16 else 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dt,N,V", [(torch.bfloat16, 64, 128256),
                                    (torch.float32, 33, 1001)])
def test_fused_ce_kernels_take_masked_logits(card, dt, N, V):
    """Rows of -inf logits but for a few entries (a masked vocabulary):
    most threads of a row see only -inf. The kernels stay finite and agree
    with the plain versions at the tolerances above; V = 1001 takes the
    scalar-load path."""
    g = torch.Generator(device=card).manual_seed(V)
    x = torch.full((N, V), float("-inf"), device=card)
    live = torch.randint(0, V, (N, 5), generator=g, device=card)
    x.scatter_(1, live, torch.randn((N, 5), generator=g, device=card) * 3)
    x = x.to(dt)
    lbl = live[:, 0].clone()
    gr = torch.rand((N,), generator=g, device=card) + 0.5
    loss, lse = ce.ce_fwd(x, lbl)
    dx = ce.ce_bwd(x, lbl, lse, gr)
    want_loss, want_lse = ce._ce_fwd_plain(x, lbl)
    want_dx = ce._ce_bwd_plain(x, lbl, want_lse, gr)
    torch.cuda.synchronize()
    assert torch.isfinite(loss).all() and torch.isfinite(lse).all()
    assert torch.isfinite(dx).all()
    _reading("loss", loss, want_loss, 1e-5, 1e-5)
    _reading("lse", lse, want_lse, 1e-5, 1e-5)
    _reading("dx", dx, want_dx, 1e-6,
             2 ** -7 if dt == torch.bfloat16 else 1e-6)


@pytest.mark.cuda
def test_fused_ce_kernels_refuse_what_they_do_not_take(card):
    x = torch.zeros((4, 8), device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="float16"):
        ce.softmax_cross_entropy(x, torch.zeros(4, dtype=torch.long,
                                                device=card))
    with pytest.raises(TypeError, match="integer"):
        ce.softmax_cross_entropy(x.float(), torch.zeros(4, device=card))
