"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs an NVIDIA GPU and nvcc: it carries the
``cuda`` marker and skips without a card. This file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import importlib
import importlib.util
from pathlib import Path

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


def _launched(call):
    """(call(), the instances it launched): the wrapper counts each launch
    under the instance that the kernel's entry reports it ran."""
    before = dict(tpa.paged_attention.instance_launches)
    out = call()
    return out, [name for name, n in
                 tpa.paged_attention.instance_launches.items()
                 for _ in range(n - before[name])]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv,D", [("bfloat16", "bfloat16", 128),
                                          ("bfloat16", "int8", 128),
                                          ("float32", "float32", 128),
                                          ("float32", "bfloat16", 64),
                                          ("bfloat16", "float32", 64),
                                          ("bfloat16", "bfloat16", 256),
                                          ("float32", "float32", 256)])
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
    got, ran = _launched(lambda: tpa.paged_attention(q, kp, vp, pt, sl,
                                                     **sc))
    want = tpa.paged_attention_reference(q, kp, vp, pt, sl, **sc)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    assert ran == ["split"]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert not got[3].any()
    # the chunk takes the tensor-core instance only with q in bf16 and
    # bf16 or int8 pools: a float32 row stays on the row-tile kernel
    qc = torch.randn((1, Hkv * G, 256, D), device=card).to(dt)
    lens = torch.tensor([400], dtype=torch.int32, device=card)
    got, ran = _launched(lambda: tpa.paged_prefill_attention(
        qc, kp, vp, pt[:1], lens, 256, **sc))
    assert ran == ["rows" if torch.float32 in (dt, kp.dtype) else "mma"]
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


# --- paged decode: the split-K instance ------------------------------------

def _split_inputs(q_dtype, kv, D, G, B, Hkv, W, ps, dev, seed):
    """Pools, distinct pages from 1 up (pad rows point at page 0) and q."""
    rng = np.random.default_rng(seed)
    P = B * W + 1
    kp, vp, sc = _pools(kv, Hkv, P, ps, D, dev, rng)
    pt = rng.permutation(np.arange(1, P))[:B * W].reshape(B, W)
    q = torch.from_numpy(rng.normal(0, 1, (B, Hkv * G, D))
                         .astype(np.float32)).to(dev, getattr(torch,
                                                             q_dtype))
    return q, kp, vp, pt.astype(np.int32), sc, P


def _split_config(name, ps, W):
    """(B, Hkv, lens) of each config. "many": 3 of 4 rows past the first
    split's 256 keys, one at the table's end (W * ps), a pad row and a row
    whose pages all are bad ids; "one": too few keys to split (W * ps <
    256), pages of 48 slots so tiles straddle pages."""
    if name == "many":
        return 5, 2, [1, W * ps, 0, 300, 700]
    return 4, 2, [W * ps, 0, 97, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("kv", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_split_decode_matches_plain(card, q_dtype, kv, D, G):
    """The decode instance at n_split > 1 and == 1, against the plain
    version. Row 1 of "many" has a bad last page id (P + 5): it reads
    nothing, so the plain version's answer is that of the other pages
    alone; row 4's pages are all bad (-1): exactly 0, as the pad row.
    Tolerance as test_paged_kernel_matches_plain."""
    atol, rtol = (1e-4, 2 ** -7) if q_dtype == "bfloat16" else (1e-5, 1e-5)
    n_sm = tpa._sm_count(torch.cuda.current_device())
    for seed, (name, ps, W) in enumerate((("many", 64, 16),
                                          ("one", 48, 5))):
        B, Hkv, lens = _split_config(name, ps, W)
        q, kp, vp, pt, sc, P = _split_inputs(q_dtype, kv, D, G, B, Hkv, W,
                                             ps, card, seed)
        n_split, _ = tpa._decode_splits(B, Hkv, W, ps, n_sm)
        assert (n_split > 1) == (name == "many"), (name, n_split)
        pt[[i for i, n in enumerate(lens) if n == 0]] = 0
        want_pt, want_lens = pt.copy(), list(lens)
        if name == "many":
            pt[1, -1] = P + 5
            want_lens[1] = (W - 1) * ps
            pt[4] = -1
            want_lens[4] = 0
        sl = torch.tensor(lens, dtype=torch.int32, device=card)
        before = tpa.paged_attention.launches
        got = tpa.paged_attention(q, kp, vp, torch.from_numpy(pt).to(card),
                                  sl, **sc)
        want = tpa.paged_attention_reference(
            q, kp, vp, torch.from_numpy(want_pt).to(card),
            torch.tensor(want_lens, dtype=torch.int32, device=card), **sc)
        torch.cuda.synchronize()
        assert tpa.paged_attention.launches == before + 1
        _reading(f"split decode {name} n_split={n_split} q {q_dtype} kv "
                 f"{kv} D={D} G={G}", got, want, atol, rtol)
        for i, n in enumerate(want_lens):
            if n == 0:
                assert not got[i].any(), f"row {i} must be exactly 0"


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_split_decode_is_deterministic(card, kv):
    """Two launches on the same inputs give the same bits: the splits
    merge in a fixed order, with no atomics on values."""
    q, kp, vp, pt, sc, _ = _split_inputs("bfloat16", kv, 128, 4, 8, 8, 32,
                                         64, card, 3)
    pt = torch.from_numpy(pt).to(card)
    sl = torch.tensor([1, 2048, 777, 64, 0, 1500, 129, 1023],
                      dtype=torch.int32, device=card)
    a = tpa.paged_attention(q, kp, vp, pt, sl, **sc)
    b = tpa.paged_attention(q, kp, vp, pt, sl, **sc)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_split_decode_never_synchronises(card):
    """A decode call, workspace and merge included, under
    ``set_sync_debug_mode("error")``: the host never reads lens, so the
    call neither synchronises nor copies from the card."""
    from paddle_tpu_torch.ops.kernels import _build

    q, kp, vp, pt, sc, _ = _split_inputs("bfloat16", "int8", 128, 4, 8, 8,
                                         32, 64, card, 4)
    pt = torch.from_numpy(pt).to(card)
    sl = torch.tensor([1, 2048, 777, 64, 0, 1500, 129, 1023],
                      dtype=torch.int32, device=card)
    _build.load(tpa._KERNEL, tpa._SIGNATURES)     # the build, beforehand
    assert tpa._decode_splits(8, 8, 32, 64, tpa._sm_count(
        torch.cuda.current_device()))[0] > 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tpa.paged_attention(q, kp, vp, pt, sl, **sc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = tpa.paged_attention_reference(q, kp, vp, pt, sl, **sc)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2 ** -7)


# --- paged prefill: the tensor-core instance --------------------------------

def _prefill_case(kv, D, G, ps, start, dev, seed):
    """A 100-token chunk at ``start`` for B = 3 over 2 kv heads: row 0 of
    length 0 (page 0: exactly 0), row 1 shorter than start + C, row 2 the
    whole table with its last page id past the pool (P + 5: it reads
    nothing). Returns the call's operands and the plain version's
    (tables with a good id there, row 2 cut before that page)."""
    B, Hkv, C = 3, 2, 100
    W = -(-(256 + C) // ps)
    rng = np.random.default_rng(seed)
    P = B * W + 1
    kp, vp, sc = _pools(kv, Hkv, P, ps, D, dev, rng)
    pt = rng.permutation(np.arange(1, P))[:B * W].reshape(B, W) \
        .astype(np.int32)
    pt[0] = 0
    lens = [0, start + C - 30, W * ps]
    want_pt, want_lens = pt.copy(), list(lens)
    pt[2, -1] = P + 5
    want_lens[2] = (W - 1) * ps
    q = torch.from_numpy(rng.normal(0, 1, (B, Hkv * G, C, D))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    i32 = (lambda a: torch.tensor(np.asarray(a), dtype=torch.int32,
                                  device=dev))
    return ((q, kp, vp, i32(pt), i32(lens), start), sc,
            (q, kp, vp, i32(want_pt), i32(want_lens)))


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_mma_prefill_matches_plain(card, kv, D, G, ps):
    """The tensor-core prefill instance at starts 0 and 256 against the
    plain version, tolerance as test_paged_kernel_matches_plain (p enters
    P.V as two bf16 parts, so the kernel's f32 value stays within about
    2^-17 of the plain version's before the one rounding of the output).
    Each call launches the kernel once, two launches give the same bits
    (no atomics), and a call under ``set_sync_debug_mode("error")``
    raises nothing (the host reads no length)."""
    from paddle_tpu_torch.ops.kernels import _build

    _build.load(tpa._KERNEL, tpa._SIGNATURES)     # the build, beforehand
    for start in (0, 256):
        args, sc, plain = _prefill_case(kv, D, G, ps, start, card,
                                        start + ps + G + D)
        before = tpa.paged_attention.launches
        got, ran = _launched(lambda: tpa.paged_prefill_attention(*args,
                                                                 **sc))
        torch.cuda.synchronize()
        assert tpa.paged_attention.launches == before + 1
        assert ran == ["mma"], "the kernel's entry reports what it ran"
        again = tpa.paged_prefill_attention(*args, **sc)
        torch.cuda.set_sync_debug_mode("error")
        try:
            quiet = tpa.paged_prefill_attention(*args, **sc)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = tpa.paged_attention_reference(*plain, **sc, q_start=start)
        torch.cuda.synchronize()
        _reading(f"mma prefill kv {kv} D={D} G={G} ps={ps} start={start}",
                 got, want, 1e-4, 2 ** -7)
        assert torch.equal(got, again) and torch.equal(got, quiet)
        assert not got[0].any(), "a length-0 row must be exactly 0"


@pytest.mark.cuda
def test_prefill_route_of_the_kernel(card):
    """The kernel's own route (``paged_attention_instance``, by which its
    launch dispatches): a chunk of more than one position with q in bf16,
    pools in bf16 or int8, head_dim 64, 128 or 256 and pages that tile a
    64-key tile whole (a multiple of 64 slots, or a divisor of 64 of at
    least 8) takes the tensor cores; float32, pages of 48, 96, 4 or 2
    slots, head_dim 96 and decode do not."""
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    for kv in (bf, i8):
        for D in (64, 128, 256):
            for ps in (8, 16, 32, 64, 128, 256):
                for chunk, G in ((2, 1), (256, 4), (7, 3), (64, 8),
                                 (16, 32)):
                    assert tpa._instance(chunk, G * chunk, bf, kv, D,
                                         ps) == "mma", (kv, D, ps, chunk)
    for args in ((256, f32, bf, 128, 64), (256, bf, f32, 128, 64),
                 (256, f32, f32, 64, 16), (256, f32, i8, 128, 64),
                 (256, bf, bf, 128, 48), (256, bf, i8, 128, 96),
                 (256, bf, bf, 128, 4), (256, bf, i8, 64, 2),
                 (256, bf, bf, 96, 64)):
        assert tpa._instance(args[0], 4 * args[0], *args[1:]) == "rows", \
            args
    # decode: the split instance at G <= 8, the row-tile kernel above
    assert tpa._instance(1, 4, bf, bf, 128, 64) == "split"
    assert tpa._instance(1, 16, bf, bf, 128, 64) == "rows"


# --- grouped and multi-head flash attention (forward, dq, dkv) --------------

fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention_gqa")
fm = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
sa = importlib.import_module("paddle_tpu_torch.ops.splash_attention")
ce = importlib.import_module("paddle_tpu_torch.ops.fused_ce")

# kernel vs plain on the same inputs. float32: f32 sums in another order
# (CUDA cores against cuBLAS in full f32). bfloat16: the same roundings on
# f32 sums in another order, plus the forward's online softmax, which rounds
# each probability against the running max rather than the final one: an
# element may land a bf16 ulp or two apart. float16: the same roundings
# to f16, whose ulp is 2^-10 relative: out within two f16 ulps on an atol
# of 2e-4; a gradient sums f16 roundings of ds that flip apart with the
# order of the f32 sums, so its error does not shrink with its size:
# about twice the readings (chip_smoke.py's GQA_TOL says which).
GQA_TOL = {torch.float32: dict(out=(1e-5, 1e-5), grad=(1e-4, 1e-4)),
           torch.bfloat16: dict(out=(2e-3, 2 ** -6), grad=(2e-3, 2 ** -6)),
           torch.float16: dict(out=(2e-4, 2 ** -9), grad=(1.5e-3, 2 ** -8))}
# the autograd path end to end: the backward of the kernel's own forward
# (its out and lse) against the plain backward of the plain forward, as
# ||g_kernel - g_plain|| / ||g_plain||; float16 an eighth of bfloat16's
# (its ulp is 8 times finer)
GQA_GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
                torch.float16: 1.25e-3}


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
                          (torch.float32, 128, 4, 256, False),
                          (torch.bfloat16, 256, 2, 512, True),
                          (torch.bfloat16, 64, 3, 256, True),
                          (torch.bfloat16, 128, 6, 256, False),
                          (torch.bfloat16, 128, 5, 512, True),
                          (torch.float16, 128, 1, 512, True),
                          (torch.float16, 64, 4, 256, False),
                          (torch.float16, 256, 2, 256, True),
                          (torch.float32, 256, 2, 256, True),
                          (torch.float32, 64, 3, 256, False),
                          (torch.float32, 64, 64, 256, True)])
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
def test_gqa_kernels_at_a_group_of_seven(card):
    """train_moe's group (Qwen2-57B-A14B: 28 / 4 heads, G = 7: one query
    head a tile) at B=2, 2 kv heads, S=1024, D=128, bf16, causal: out, lse
    and dq element by element against the plain versions (GQA_TOL). dk
    and dv sum each key's bf16-rounded products over the group's 7 heads
    and its queries, so the kernel and the plain version are two roundings
    of one f32 sum whose gap does not shrink where the sum cancels: each
    is held against the f32 truth (the plain backward in f32 on the same
    bf16 inputs), the kernel's relative error within 1.1 x the plain
    version's, the bf16 train tests' rule. Readings printed with -s."""
    q, k, v, do = _gqa_inputs(2, 2, 7, 1024, 128, torch.bfloat16, card,
                              seed=1152)
    tol = GQA_TOL[torch.bfloat16]
    out, lse = fa.gqa_fwd(q, k, v, True)
    want_out, want_lse = fa._gqa_fwd_plain(q, k, v, True)
    _reading("out", out, want_out, *tol["out"])
    _reading("lse", lse, want_lse, 1e-5, 1e-5)
    delta = (do.float() * want_out.float()).sum(-1)
    got = fa.gqa_bwd(q, k, v, do, want_lse, delta, True)
    plain = fa._gqa_bwd_plain(q, k, v, do, want_lse, delta, True)
    _reading("dq", got[0], plain[0], *tol["grad"])
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    out_f, lse_f = fa._gqa_fwd_plain(qf, kf, vf, True)
    truth = fa._gqa_bwd_plain(qf, kf, vf, dof, lse_f,
                              (dof * out_f).sum(-1), True)
    torch.cuda.synchronize()
    for name, g, p, t in zip(("dk", "dv"), got[1:], plain[1:], truth[1:]):
        err = (g.float() - p.float()).abs() / (tol["grad"][0]
                                               + tol["grad"][1]
                                               * p.float().abs())
        kernel, ref = _rel(g, t), _rel(p, t)
        print(f"reading {name}: kernel {kernel:.4g}, plain {ref:.4g} from "
              f"the f32 truth; against the plain version err/limit "
              f"{float(err.max()):.3f}")
        assert kernel <= 1.1 * ref


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 3])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_backward_kernels_at_one_head(card, D, G, causal):
    """The wgmma dq and dk/dv kernels at one kv head and S = 256, where a
    wrong shared-memory descriptor or TMA box shows as wrong numbers: each
    against the plain backward element by element (tolerance as above),
    and two launches on the same inputs bit-identical (no atomics). At
    D = 256 two CTAs share a tile's output columns; G = 3 does not divide
    the row tile, so a tile holds one query head."""
    dt = torch.bfloat16
    q, k, v, do = _gqa_inputs(1, 1, G, 256, D, dt, card,
                              seed=D + G + int(causal))
    scale = D ** -0.5
    want_out, lse = fa._gqa_fwd_plain(q, k, v, causal)
    delta = (do.float() * want_out.float()).sum(-1)
    runs = [(fa._launch_dq(q, k, v, do, lse, delta, causal, scale),
             *fa._launch_dkv(q, k, v, do, lse, delta, causal, scale))
            for _ in range(2)]
    want = fa._gqa_bwd_plain(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    for name, a, b, w in zip(("dq", "dk", "dv"), *runs, want):
        _reading(name, a, w, *GQA_TOL[dt]["grad"])
        assert torch.equal(a, b), f"{name} differs between two launches"


@pytest.mark.cuda
def test_gqa_kernels_refuse_what_they_do_not_take(card):
    q, k, v, _ = _gqa_inputs(1, 2, 2, 256, 96, torch.bfloat16, card, 1)
    with pytest.raises(ValueError, match="head_dim 96"):
        fa.grouped_flash_attention(q, k, v, True)
    q, k, v, _ = _gqa_inputs(1, 2, 2, 256, 64, torch.float64, card, 2)
    with pytest.raises(TypeError, match="float64"):
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
def test_mha_at_flash_shapes_launches_the_kernels(card):
    """kv_heads == heads at a flash-eligible length runs the multi-head
    flash kernels (the grouped kernels at G = 1), counted on
    ``flash_attention`` and not on the grouped entry point, and agrees
    with the same model's plain path on the CPU."""
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             load_numpy_state_dict)

    cfg = LlamaConfig.tiny(hidden=256, heads=4, kv_heads=4)   # f32
    model = LlamaForCausalLM(cfg, device=card, seed=3)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 256)))
    mha, gqa = fm.flash_attention, fa.grouped_flash_attention
    before = (mha.launches_fwd, gqa.launches_fwd)
    with torch.no_grad():
        got = model(tokens.to(card)).cpu()
    torch.cuda.synchronize()
    assert (mha.launches_fwd, gqa.launches_fwd) == \
        (before[0] + cfg.num_hidden_layers, before[1])
    cpu = load_numpy_state_dict(
        LlamaForCausalLM(cfg, device="cpu"),
        {k: v.cpu().numpy() for k, v in model.state_dict().items()})
    with torch.no_grad():
        want = cpu(tokens)
    _reading("logits", got, want, 1e-4, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 256])
def test_sdpa_float16_launches_the_flash_kernels(card, D):
    """``scaled_dot_product_attention`` on float16 at a flash-eligible
    shape (the gate reads no dtype, as the reference's) launches the
    multi-head flash kernels, returns float16 and agrees with the plain
    forward; its backward launches dq and dk/dv."""
    from paddle_tpu_torch.nn.functional.attention import \
        scaled_dot_product_attention

    g = torch.Generator(device=card).manual_seed(D)
    q, k, v, do = (torch.randn((1, 256, 2, D), generator=g, device=card)
                   .to(torch.float16) for _ in range(4))
    mha = fm.flash_attention
    before = (mha.launches_fwd, mha.launches_dq, mha.launches_dkv)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert out.dtype == torch.float16
    assert (mha.launches_fwd, mha.launches_dq, mha.launches_dkv) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    want, _ = fa._gqa_fwd_plain(*(t.transpose(1, 2) for t in (q, k, v)),
                                True)
    _reading("out", out.detach(), want.transpose(1, 2),
             *GQA_TOL[torch.float16]["out"])


@pytest.mark.cuda
@pytest.mark.parametrize("dt,D,Sq,Sk,causal",
                         [(torch.bfloat16, 128, 1024, 1024, True),
                          (torch.bfloat16, 128, 512, 1024, True),
                          (torch.bfloat16, 64, 1024, 512, False),
                          (torch.float32, 64, 256, 256, True),
                          (torch.float32, 128, 256, 512, True)])
def test_mha_kernels_match_plain(card, dt, D, Sq, Sk, causal):
    """``flash_attention`` (the grouped kernels at G = 1) against the plain
    versions, Sq = Sk and Sq != Sk (top-left causal): out and lse, then dq,
    dk and dv on the plain forward's residuals, then the autograd Function
    end to end with each kernel launched once on ``flash_attention``.
    Tolerances as for the grouped kernels."""
    g = torch.Generator(device=card).manual_seed(Sq + Sk + D)
    q, do = (torch.randn((2, 4, Sq, D), generator=g, device=card).to(dt)
             for _ in range(2))
    k, v = (torch.randn((2, 4, Sk, D), generator=g, device=card).to(dt)
            for _ in range(2))
    tol = GQA_TOL[dt]
    mha = fm.flash_attention
    out, lse = fm.mha_fwd(q, k, v, causal)
    want_out, want_lse = fa._gqa_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    _reading("out", out, want_out, *tol["out"])
    _reading("lse", lse, want_lse, 1e-5, 1e-5)
    delta = (do.float() * want_out.float()).sum(-1)
    want = fa._gqa_bwd_plain(q, k, v, do, want_lse, delta, causal)
    got = fm.mha_bwd(q, k, v, do, want_lse, delta, causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dt and a.shape == b.shape
        _reading(name, a, b, *tol["grad"])
    launches = (mha.launches_fwd, mha.launches_dq, mha.launches_dkv)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    mha(qg, kg, vg, causal).backward(do)
    torch.cuda.synchronize()
    assert (mha.launches_fwd, mha.launches_dq, mha.launches_dkv) == \
        (launches[0] + 1, launches[1] + 1, launches[2] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad),
                          want):
        rel = _rel(a, b)
        print(f"reading autograd {name}: relative norm error {rel:.3g}")
        assert rel <= GQA_GRAD_REL[dt]


# --- splash attention (forward, dq, dkv) -----------------------------------

def _random_mask(nq, nk, seed, empty_row):
    bm = np.random.default_rng(seed).random((nq, nk)) < 0.5
    bm[:, 0] |= True
    bm[empty_row] = False
    return bm


# (name, dtype, G, Sq, Sk, D, block_q, block_k, mask, causal, window,
# q_offset): the band of the windowed models at G = 4 and G = 1, a random
# mask with an empty block row (out 0, lse NEG_INF), a live block wholly
# above the diagonal (its rows see no key), a shifted query frame, mask
# blocks smaller than the kernels' tiles, f32, a kv group of 3 (one query
# head a tile), head_dim 256 and float16
SPLASH_CASES = [
    ("band_g4", torch.bfloat16, 4, 1024, 1024, 128, 128, 128,
     sa.banded_block_mask(1024, 1024, 128, 128, 300), True, 300, 0),
    ("band_g1", torch.bfloat16, 1, 1024, 1024, 128, 64, 64,
     sa.banded_block_mask(1024, 1024, 64, 64, 256), True, 256, 0),
    ("random_empty_row", torch.bfloat16, 2, 512, 512, 64, 64, 64,
     _random_mask(8, 8, 0, 3), False, None, 0),
    ("above_diagonal", torch.bfloat16, 4, 256, 256, 128, 128, 128,
     np.array([[False, True], [True, True]]), True, None, 0),
    ("q_offset", torch.bfloat16, 2, 256, 512, 128, 128, 128,
     np.ones((2, 4), bool), True, 200, 256),
    ("small_blocks", torch.bfloat16, 4, 512, 512, 128, 16, 16,
     _random_mask(32, 32, 1, 5), True, None, 0),
    ("f32_band", torch.float32, 2, 256, 256, 64, 32, 32,
     sa.banded_block_mask(256, 256, 32, 32, 100), True, 100, 0),
    ("band_g3", torch.bfloat16, 3, 1024, 1024, 128, 64, 64,
     sa.banded_block_mask(1024, 1024, 64, 64, 300), True, 300, 0),
    ("band_d256", torch.bfloat16, 2, 512, 512, 256, 64, 64,
     sa.banded_block_mask(512, 512, 64, 64, 200), True, 200, 0),
    ("f16_random_empty_row", torch.float16, 2, 512, 512, 64, 64, 64,
     _random_mask(8, 8, 2, 5), False, None, 0),
    ("f32_band_g3_d256", torch.float32, 3, 256, 256, 256, 32, 32,
     sa.banded_block_mask(256, 256, 32, 32, 100), True, 100, 0),
]


def _splash_inputs(dt, G, Sq, Sk, D, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((2, 2 * G, Sq, D), generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((2, 2, Sk, D), generator=g, device=dev).to(dt)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLASH_CASES, ids=[c[0] for c in SPLASH_CASES])
def test_splash_kernels_match_plain(card, case):
    """The forward kernel (out, lse), then the dq and dk/dv kernels on the
    plain forward's residuals, each against its plain version element by
    element (tolerances as for the grouped flash kernels; rows with no live
    key must give exactly out 0 and lse NEG_INF); then the autograd
    Function end to end, each kernel launched once."""
    _, dt, G, Sq, Sk, D, bq, bk, bm, causal, window, off = case
    q, k, v, do = _splash_inputs(dt, G, Sq, Sk, D, card, seed=Sq + G)
    pat = sa._pattern(q, k, bm, causal, bq, bk, window, off)
    tol = GQA_TOL[dt]
    spl = sa.splash_attention
    out, lse = sa.splash_fwd(q, k, v, pat)
    want_out, want_lse = sa._splash_fwd_plain(q, k, v, pat)
    torch.cuda.synchronize()
    _reading("out", out, want_out, *tol["out"])
    _reading("lse", lse, want_lse, 1e-5, 1e-5)
    empty = ~sa._live_pairs(pat, Sq, Sk, card).any(-1)
    assert torch.equal(lse[..., empty], want_lse[..., empty])
    assert not out[:, :, empty].any()
    delta = (do.float() * want_out.float()).sum(-1)
    got = sa.splash_bwd(q, k, v, do, want_lse, delta, pat)
    want = sa._splash_bwd_plain(q, k, v, do, want_lse, delta, pat)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dt and a.shape == b.shape
        assert torch.isfinite(a).all()
        _reading(name, a, b, *tol["grad"])
    launches = (spl.launches_fwd, spl.launches_dq, spl.launches_dkv)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    spl(qg, kg, vg, bm, causal, None, bq, bk, window, off).backward(do)
    torch.cuda.synchronize()
    assert (spl.launches_fwd, spl.launches_dq, spl.launches_dkv) == \
        (launches[0] + 1, launches[1] + 1, launches[2] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad),
                          want):
        rel = _rel(a, b)
        print(f"reading autograd {name}: relative norm error {rel:.3g}")
        assert rel <= GQA_GRAD_REL[dt]


@pytest.mark.cuda
def test_splash_kernels_refuse_what_they_do_not_take(card):
    bm = np.ones((2, 2), bool)
    q, k, v, _ = _splash_inputs(torch.bfloat16, 2, 256, 256, 96, card, 1)
    with pytest.raises(ValueError, match="head_dim 96"):
        sa.splash_attention(q, k, v, bm, True)
    q, k, v, _ = _splash_inputs(torch.float64, 2, 256, 256, 64, card, 2)
    with pytest.raises(TypeError, match="float64"):
        sa.splash_attention(q, k, v, bm, True)
    q, k, v, _ = _splash_inputs(torch.bfloat16, 2, 256, 256, 64, card, 3)
    with pytest.raises(ValueError, match="does not tile"):
        sa.splash_attention(q, k, v, np.ones((3, 2), bool), True)
    with pytest.raises(TypeError, match="share one dtype"):
        sa.splash_attention(q, k.float(), v, bm, True)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_heads,window", [(2, 256), (8, None)],
                         ids=["window", "mha"])
def test_bf16_config_train_grads_are_as_close_to_f32_as_the_plain_versions(
        card, monkeypatch, kv_heads, window):
    """A bf16 Llama (hidden 1024, 8 heads, head_dim 128, 4 layers, vocab
    4096, B=2, S=1024) with a sliding window of 256 over 2 kv heads (the
    splash kernels) or with 8 kv heads (multi-head flash): as the grouped
    test above, the kernels may not be further from the f32 truth than
    the plain versions by more than a tenth, for the worst parameter and
    for the median one. The losses' distances from the truth are printed
    beside them."""
    import dataclasses
    import statistics

    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             param_views)
    from paddle_tpu_torch.models.nlp.llama_functional import loss_fn

    cfg = dataclasses.replace(
        LlamaConfig.tiny(vocab=4096, hidden=1024, layers=4, heads=8,
                         kv_heads=kv_heads), dtype=torch.bfloat16,
        sliding_window=window)
    model = LlamaForCausalLM(cfg, device=card, seed=0)
    rng = np.random.default_rng(0)
    tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (2, 1024))).to(card)
                      for _ in range(2))
    owner, swaps = ((sa.splash_attention,
                     [(sa, "splash_fwd", sa._splash_fwd_plain),
                      (sa, "splash_bwd", sa._splash_bwd_plain)])
                    if window else
                    (fm.flash_attention,
                     [(fm, "mha_fwd", fa._gqa_fwd_plain),
                      (fm, "mha_bwd", fa._gqa_bwd_plain)]))

    def grads(params, plain):
        with monkeypatch.context() as m:
            if plain:
                for mod, name, fn in swaps + [
                        (ce, "ce_fwd", ce._ce_fwd_plain),
                        (ce, "ce_bwd", ce._ce_bwd_plain)]:
                    m.setattr(mod, name, fn)
            outer, layers = param_views(params, cfg.num_hidden_layers)
            loss = loss_fn(cfg, outer, layers, tokens, labels, remat=False)
            return float(loss), torch.autograd.grad(loss,
                                                    list(params.values()))

    bf = {k: p.detach().requires_grad_() for k, p in
          model.named_parameters()}
    f32 = {k: p.detach().float().requires_grad_() for k, p in bf.items()}
    launches = (owner.launches_fwd, owner.launches_dq, owner.launches_dkv)
    loss_k, g_kernel = grads(bf, plain=False)
    assert (owner.launches_fwd, owner.launches_dq, owner.launches_dkv) == \
        tuple(n + cfg.num_hidden_layers for n in launches)
    loss_p, g_plain = grads(bf, plain=True)
    loss_t, g_true = grads(f32, plain=True)
    kernel = [_rel(a, t) for a, t in zip(g_kernel, g_true)]
    plain = [_rel(a, t) for a, t in zip(g_plain, g_true)]
    print(f"reading vs f32: kernels max {max(kernel):.4g} median "
          f"{statistics.median(kernel):.4g}; plain max {max(plain):.4g} "
          f"median {statistics.median(plain):.4g}; loss - truth: kernels "
          f"{loss_k - loss_t:.3g}, plain {loss_p - loss_t:.3g}")
    assert max(kernel) <= 1.1 * max(plain)
    assert statistics.median(kernel) <= 1.1 * statistics.median(plain)


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


lnm = importlib.import_module("paddle_tpu_torch.ops.layer_norm")
dl = importlib.import_module("paddle_tpu_torch.ops.dropout_ln")

# norm kernels vs plain on the same inputs: f32 statistics on both sides,
# apart by the order of the row sums; a bf16 output rounds once (one ulp,
# 2^-7 of |want|), an f32 one stays within 1e-5
NORM_TOL = {torch.bfloat16: (1e-5, 2 ** -7), torch.float32: (1e-5, 1e-5)}
# dropout bits at the edges of keep = f32(bits) / 2^32 >= p: onto
# f32(0.1) * 2^32 = 429496736, from 2^31 up, near 2^32 (u rounds to 1.0)
EDGE_BITS = [0, 1, 429496719, 429496720, 429496721, 429496735, 429496736,
             429496737, 2 ** 31 - 65, 2 ** 31 - 64, 2 ** 31 - 1, 2 ** 31,
             2 ** 31 + 1, 2 ** 32 - 129, 2 ** 32 - 128, 2 ** 32 - 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dt,wdt", [(torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("shape,eps", [((512, 768), 1e-5),
                                       ((3, 7, 100), 1e-5),
                                       ((33, 4096), 1e-12),
                                       ((5, 20000), 1e-5)])
def test_norm_kernels_match_plain(card, dt, wdt, shape, eps):
    """``fused_layer_norm`` and ``fused_rms_norm`` against ``_ln_plain`` /
    ``_rms_plain``: 16-byte rows, odd widths (scalar loads), rows past the
    registers (re-read), eps 1e-12; one launch each."""
    g = torch.Generator(device=card).manual_seed(0)
    H = shape[-1]
    x = (torch.randn(shape, generator=g, device=card) * 2 + 0.5).to(dt)
    w = (1 + 0.5 * torch.randn(H, generator=g, device=card)).to(wdt)
    b = torch.randn(H, generator=g, device=card).to(wdt)
    before = (lnm.fused_layer_norm.launches, lnm.fused_rms_norm.launches)
    ln = lnm.fused_layer_norm(x, w, b, eps)
    rms = lnm.fused_rms_norm(x, w, eps)
    torch.cuda.synchronize()
    assert (lnm.fused_layer_norm.launches, lnm.fused_rms_norm.launches) == \
        (before[0] + 1, before[1] + 1)
    assert ln.dtype == dt and ln.shape == x.shape
    _reading("layer norm", ln, lnm._ln_plain(x, w, b, eps), *NORM_TOL[dt])
    _reading("rms norm", rms, lnm._rms_plain(x, w, eps), *NORM_TOL[dt])


def _dln_bits(N, H, dev, seed):
    bits = torch.empty((N, H), dtype=torch.int32, device=dev).random_(
        -2 ** 31, 2 ** 31, generator=torch.Generator(device=dev)
        .manual_seed(seed))
    edges = torch.tensor(EDGE_BITS, dtype=torch.int64)[:H].to(torch.int32)
    bits[:, :edges.numel()] = edges.to(dev)
    return bits


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,H", [(1024, 768), (130, 100), (7, 20000)])
@pytest.mark.parametrize("p,training", [(0.1, True), (0.5, True),
                                        (0.0, True), (0.1, False)])
def test_dropout_add_ln_kernel_matches_plain(card, dt, N, H, p, training):
    """The dropout-add-LayerNorm kernel against ``_forward_plain`` on the
    same bits (every row holding the edges of the keep decision), and,
    where it drops, the keep mask exactly: with x = 100, |res| < 1, w = 1,
    b = 0 the output is above 0 exactly where x was kept. The bits are
    given as int32 and as uint32 holding the same bits."""
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((N, H), generator=g, device=card).to(dt)
    res = torch.randn((N, H), generator=g, device=card).to(dt)
    w = (1 + 0.5 * torch.randn(H, generator=g, device=card)).to(dt)
    b = torch.randn(H, generator=g, device=card).to(dt)
    bits = _dln_bits(N, H, card, 2)
    before = dl.fused_dropout_add_layer_norm.launches
    got = dl.fused_dropout_add_layer_norm(x, res, w, b, p, 1e-5, training,
                                          bits=bits)
    torch.cuda.synchronize()
    assert dl.fused_dropout_add_layer_norm.launches == before + 1
    want = dl._forward_plain(x, res, w, b, bits, p, 1e-5, training)
    _reading("dropout-add-LN", got, want, *NORM_TOL[dt])
    if training and p > 0:
        xs = torch.full_like(x, 100.0)
        rs = (torch.rand((N, H), generator=g, device=card) * 2 - 1).to(dt)
        ones, zeros = torch.ones_like(w), torch.zeros_like(b)
        rule = dl._uniform(bits) >= p
        for given in (bits, bits.view(torch.uint32)):
            kept = dl.fused_dropout_add_layer_norm(
                xs, rs, ones, zeros, p, 1e-5, True, bits=given) > 0
            assert torch.equal(kept, rule)
        assert torch.equal(dl._forward_plain(xs, rs, ones, zeros, bits, p,
                                             1e-5, True) > 0, rule)


@pytest.mark.cuda
def test_norm_kernels_refuse_what_they_do_not_take(card):
    x = torch.randn(4, 64, device=card)
    w, b = torch.ones(64, device=card), torch.zeros(64, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lnm.fused_layer_norm(x.half(), w, b)
    with pytest.raises(TypeError, match="share one dtype"):
        lnm.fused_layer_norm(x, w, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="must lie on"):
        lnm.fused_rms_norm(x, w.cpu())
    with pytest.raises(TypeError, match="residual dtype"):
        dl.fused_dropout_add_layer_norm(x, x.to(torch.bfloat16), w, b)


@pytest.mark.cuda
def test_bf16_encoder_grads_are_as_close_to_f32_as_the_plain_versions(
        card, monkeypatch):
    """Two bf16 post-LN ``FusedTransformerEncoderLayer``s (d 256, 4 heads,
    head_dim 64, FFN 1024, B=4, S=512, dropout 0.1 from one reseeded
    generator, so every run draws the same masks and bits): the gradients
    of an MSE loss through the kernels (multi-head flash, dropout-add-LN)
    and through their plain versions, each against the same weights in
    f32 through the plain versions (the truth). The kernels may not be
    further from the truth than the plain versions by more than a tenth,
    for the worst parameter and for the median one. The key bias is left
    out: its gradient is 0 but for rounding noise (a key bias shifts a
    query's scores alike, which the softmax does not see)."""
    import statistics

    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer

    gen = Generator(0)
    stack = torch.nn.ModuleList([
        FusedTransformerEncoderLayer(256, 4, 1024, dropout_rate=0.1,
                                     activation="gelu", device=card,
                                     generator=gen) for _ in range(2)]
    ).to(torch.bfloat16)          # the truth takes these weights in f32
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((4, 512, 256), generator=g, device=card)
    tgt = torch.randn((4, 512, 256), generator=g, device=card)

    def grads(dtype, plain):
        model = stack.to(dtype)
        with monkeypatch.context() as m:
            if plain:
                m.setattr(fm, "mha_fwd", fa._gqa_fwd_plain)
                m.setattr(fm, "mha_bwd", fa._gqa_bwd_plain)
                m.setattr(dl, "dropout_add_ln_fwd", dl._forward_plain)
            gen.manual_seed(5)
            h = x.to(dtype)
            for layer in model:
                h = layer(h)
            loss = torch.square(h.float() - tgt).mean()
            out = torch.autograd.grad(loss, list(model.parameters()),
                                      allow_unused=True)
        return [None if t is None else t.float() for t in out]

    g_true = grads(torch.float32, plain=True)
    launches = (dl.fused_dropout_add_layer_norm.launches,
                fm.flash_attention.launches_dkv)
    g_kernel = grads(torch.bfloat16, plain=False)
    assert (dl.fused_dropout_add_layer_norm.launches,
            fm.flash_attention.launches_dkv) == (launches[0] + 4,
                                                  launches[1] + 2)
    g_plain = grads(torch.bfloat16, plain=True)
    keep = [t is not None and not k.endswith("attn.k_proj.bias")
            for (k, _), t in zip(stack.named_parameters(), g_true)]
    kernel = [_rel(a, t) for a, t, k in zip(g_kernel, g_true, keep) if k]
    plain = [_rel(a, t) for a, t, k in zip(g_plain, g_true, keep) if k]
    print(f"reading vs f32: kernels max {max(kernel):.4g} median "
          f"{statistics.median(kernel):.4g}; plain max {max(plain):.4g} "
          f"median {statistics.median(plain):.4g}")
    assert max(kernel) <= 1.1 * max(plain)
    assert statistics.median(kernel) <= 1.1 * statistics.median(plain)


@pytest.mark.cuda
def test_bf16_bert_grads_are_as_close_to_f32_as_the_plain_versions(
        card, monkeypatch):
    """A bf16 ``BertForPretraining`` (2 layers, hidden 256, 4 heads,
    head_dim 64, FFN 1024, vocab 2048, B=4, S=512, dropout 0.1 from one
    reseeded generator, so every run draws the same masks): the
    gradients of the pretraining loss (``bert.pretrain_loss``: MLM on 15 %
    of positions, NSP) through the multi-head flash kernels and through
    their plain versions, each against the same weights in f32 through
    the plain versions (the truth). One forward+backward launches each
    flash kernel once a layer. The kernels may not be further from the
    truth than the plain versions by more than a tenth, for the worst
    parameter and for the median one; the key bias is left out (its
    gradient is rounding noise)."""
    import statistics

    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.models.nlp import BertConfig, BertForPretraining
    from paddle_tpu_torch.models.nlp.bert import pretrain_loss

    cfg = BertConfig(vocab_size=2048, hidden_size=256, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=1024)
    gen = Generator(0)
    model = BertForPretraining(cfg, device=card, generator=gen) \
        .to(torch.bfloat16)       # the truth takes these weights in f32
    g = torch.Generator(device=card).manual_seed(1)
    B, S = 4, 512
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=card)
    types = (torch.arange(S, device=card) >= S // 2).long().expand(B, S)
    mlm = torch.where(torch.rand((B, S), generator=g, device=card) < 0.15,
                      ids, -100)
    nsp = torch.randint(0, 2, (B,), generator=g, device=card)

    def grads(dtype, plain):
        m = model.to(dtype)
        with monkeypatch.context() as mp:
            if plain:
                mp.setattr(fm, "mha_fwd", fa._gqa_fwd_plain)
                mp.setattr(fm, "mha_bwd", fa._gqa_bwd_plain)
            gen.manual_seed(5)
            loss = pretrain_loss(m, ids, types, mlm, nsp)
            out = torch.autograd.grad(loss, list(m.parameters()))
        return [t.float() for t in out]

    g_true = grads(torch.float32, plain=True)
    before = (fm.flash_attention.launches_fwd, fm.flash_attention.launches_dq,
              fm.flash_attention.launches_dkv)
    g_kernel = grads(torch.bfloat16, plain=False)
    assert (fm.flash_attention.launches_fwd, fm.flash_attention.launches_dq,
            fm.flash_attention.launches_dkv) == tuple(n + 2 for n in before)
    g_plain = grads(torch.bfloat16, plain=True)
    keep = [not k.endswith("self_attn.k_proj.bias")
            for k, _ in model.named_parameters()]
    kernel = [_rel(a, t) for a, t, k in zip(g_kernel, g_true, keep) if k]
    plain = [_rel(a, t) for a, t, k in zip(g_plain, g_true, keep) if k]
    print(f"reading vs f32: kernels max {max(kernel):.4g} median "
          f"{statistics.median(kernel):.4g}; plain max {max(plain):.4g} "
          f"median {statistics.median(plain):.4g}")
    assert max(kernel) <= 1.1 * max(plain)
    assert statistics.median(kernel) <= 1.1 * statistics.median(plain)


# --- the Llama training step's options (remat, offload, chunked CE) ------

def _option_model(dev, **fields):
    """A bf16 GQA Llama at a flash-eligible shape (hidden 1024, 8 / 2
    heads, head_dim 128, 2 layers, vocab 4096), made from a seed, and a
    batch (B=2, S=512)."""
    import dataclasses

    from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM

    cfg = dataclasses.replace(
        LlamaConfig.tiny(vocab=4096, hidden=1024, layers=2, heads=8,
                         kv_heads=2), dtype=torch.bfloat16, **fields)
    rng = np.random.default_rng(0)
    batch = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512)))
             .to(dev) for _ in range(2)]
    return LlamaForCausalLM(cfg, device=dev, seed=0), batch


@pytest.mark.cuda
def test_offloaded_moments_are_pinned_and_bit_equal(card):
    """3 steps with AdamW's moments in pinned host memory, streamed
    through the card in chunks, against 3 with the moments on the card:
    the same losses, parameters and moments, bit for bit."""
    from paddle_tpu_torch.models.nlp import llama_train_step_factory

    runs = {}
    for offload in (False, True):
        model, (tokens, labels) = _option_model(card)
        params, opt, step = llama_train_step_factory(
            model, learning_rate=1e-3, remat=False, device=card,
            offload_moments=offload)
        losses = [float(step(params, opt, tokens, labels)[2])
                  for _ in range(3)]
        torch.cuda.synchronize()
        runs[offload] = (losses, params, opt)
    (losses, params, opt), (o_losses, o_params, o_opt) = \
        runs[False], runs[True]
    assert all(m.is_pinned() and not m.is_cuda for name in ("m", "v")
               for m in o_opt[name].values())
    assert losses == o_losses
    for k in params:
        assert torch.equal(params[k], o_params[k]), k
        for name in ("m", "v"):
            assert torch.equal(opt[name][k].cpu(), o_opt[name][k]), k


@pytest.mark.cuda
def test_remat_modes_give_the_same_bits_on_the_card(card):
    """remat False / True / "dots" on a fused-projection model: the same
    loss and gradients, bit for bit (the same operations, deterministic
    kernels); the grouped flash forward launches once a layer without
    remat and twice with True or "dots", dq and dk/dv once a layer in
    all."""
    from paddle_tpu_torch.models.nlp import param_views
    from paddle_tpu_torch.models.nlp.llama_functional import loss_fn

    model, (tokens, labels) = _option_model(
        card, fuse_attention_qkv=True, fuse_ffn_gate_up=True)
    params = {k: p.requires_grad_() for k, p in model.named_parameters()}
    L = model.config.num_hidden_layers
    owner = fa.grouped_flash_attention
    out = {}
    for remat in (False, True, "dots"):
        before = (owner.launches_fwd, owner.launches_dq, owner.launches_dkv)
        outer, layers = param_views(params, L)
        loss = loss_fn(model.config, outer, layers, tokens, labels, remat)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        launched = tuple(n - b for n, b in zip(
            (owner.launches_fwd, owner.launches_dq, owner.launches_dkv),
            before))
        assert launched == ((L if remat is False else 2 * L), L, L), remat
        out[remat] = (loss.detach(), grads)
    for remat in (True, "dots"):
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(out[remat][1], out[False][1]))
        print(f"remat={remat!r}: loss {float(out[remat][0]):.6f} against "
              f"{float(out[False][0]):.6f}, largest gradient difference "
              f"{diff:.3g}")
        assert torch.equal(out[remat][0], out[False][0])
        assert diff == 0.0


@pytest.mark.cuda
def test_chunked_ce_on_the_card_matches_the_cpu(card):
    """The chunked CE on bf16 inputs (V = 4099 in chunks of 1024, the
    last padded), card against CPU: the chunk logits are f32 products of
    the same bf16 values (cuBLAS writes f32 on the card, the CPU widens
    first), apart by the order of the sums: loss 1e-5 relative; dx and dw
    round f32 sums to bf16 once, so one bf16 ulp apart at most: 1e-6 +
    2^-7 of |cpu|."""
    from paddle_tpu_torch.ops.chunked_ce import chunked_causal_lm_loss

    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 256, 512), generator=g).to(torch.bfloat16)
    w = (torch.randn((4099, 512), generator=g) * 0.05).to(torch.bfloat16)
    labels = torch.randint(0, 4099, (2, 256), generator=g)

    def run(dev):
        xd = x.to(dev).requires_grad_()
        wd = w.to(dev).requires_grad_()
        loss = chunked_causal_lm_loss(xd, wd, labels.to(dev), 1024)
        return (loss.detach().cpu(), *(t.float().cpu() for t in
                                       torch.autograd.grad(loss, (xd, wd))))

    got, want = run(card), run(torch.device("cpu"))
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    for name, a, b in zip(("dx", "dw"), got[1:], want[1:]):
        print(f"{name}: largest err / tol "
              f"{float(((a - b).abs() / (1e-6 + 2 ** -7 * b.abs())).max()):.3g}")
        torch.testing.assert_close(a, b, atol=1e-6, rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["indexed", "inverted", "einsum"])
def test_moe_on_the_card_matches_the_cpu(card, mode):
    """A small f32 MoE (hidden 256, 4 / 2 heads: head_dim 64 and kv groups
    of 2 at S = 256, the grouped flash kernels on the card; 8 routed
    experts top-2 and one shared expert, 2 layers) from the same weights
    on the card and on the CPU: logits and aux 1e-4 (order of f32 sums
    only; TF32 off), then 3 steps of ``moe_train_step_factory``: losses
    1e-5, parameters at most 1e-4 of a tensor's elements (or one) beyond
    1e-5 and none beyond lr. The grouped kernels launch once a layer a
    step each way."""
    from paddle_tpu_torch.models.nlp import (MoEConfig, MoEForCausalLM,
                                             load_numpy_state_dict,
                                             moe_train_step_factory)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MoEConfig(vocab_size=256, hidden_size=256, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, num_experts=8, top_k=2,
                    moe_every=1, num_shared_experts=1, dispatch_mode=mode)
    state = {k: v.numpy() for k, v in MoEForCausalLM(
        cfg, device="cpu", seed=1).state_dict().items()}
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, 256, (2, 257)))
    gfa = fa.grouped_flash_attention
    runs = {}
    for dev in (card, torch.device("cpu")):
        model = load_numpy_state_dict(MoEForCausalLM(cfg, device=dev),
                                      state)
        with torch.no_grad():
            logits = model(tok[:, :-1].to(dev)).cpu()
            aux = float(model.aux_loss())
        params, opt, step = moe_train_step_factory(
            model, learning_rate=1e-3, device=dev)
        before = (gfa.launches_fwd, gfa.launches_dq, gfa.launches_dkv)
        losses = [float(step(params, opt, tok[:, :-1], tok[:, 1:])[2])
                  for _ in range(3)]
        launched = tuple(n - b for n, b in zip(
            (gfa.launches_fwd, gfa.launches_dq, gfa.launches_dkv), before))
        runs[dev.type] = (logits, aux, losses, launched,
                          {k: p.detach().cpu() for k, p in params.items()})
    (lg, aux, losses, launched, params), (lg_c, aux_c, losses_c, none,
                                          params_c) = runs["cuda"], runs["cpu"]
    print(f"{mode}: logits {float((lg - lg_c).abs().max()):.3g}, aux "
          f"{abs(aux - aux_c):.3g}, losses "
          f"{max(abs(a - b) for a, b in zip(losses, losses_c)):.3g}")
    torch.testing.assert_close(lg, lg_c, atol=1e-4, rtol=0)
    assert abs(aux - aux_c) <= 1e-4
    np.testing.assert_allclose(losses, losses_c, atol=1e-5, rtol=0)
    assert launched == (6, 6, 6) and none == (0, 0, 0)
    for k, p in params.items():
        diff = (p - params_c[k]).abs()
        assert int((diff > 1e-5).sum()) <= max(1, 1e-4 * diff.numel()), k
        assert float(diff.max()) <= 1e-3, k


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_serving_engine_on_the_card_matches_the_cpu(card, kv_quant):
    """ServingEngine on the fixed clock over a small f32 Llama's serving
    factory (head_dim 64), on the card and on the CPU, under the routed,
    dense and paged policies: the same outputs, slot logs and reports
    (and the same outputs across policies with full-precision caches:
    the int8 codec rounds another set of keys in the dense cache than in
    the pages); on the card every paged decode step launches the split
    instance once a layer (prefill chunks attend by the plain page
    gather)."""
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_serving_decode_factory,
                                             load_numpy_state_dict)
    from paddle_tpu_torch.obs import Tracer
    from paddle_tpu_torch.serving import (ServingEngine, merge_traces,
                                          synthesize_trace)

    cfg = LlamaConfig.tiny(vocab=97, hidden=256, layers=2, heads=4,
                           kv_heads=2)
    state = {k: v.numpy() for k, v in
             LlamaForCausalLM(cfg, device="cpu", seed=15).state_dict()
             .items()}
    trace = merge_traces(
        synthesize_trace(seed=3, n_requests=6, mean_interarrival=0.5,
                         prompt_len=(4, 30), output_len=(3, 8),
                         vocab_size=97, churn_frac=0.3, rid_prefix="r"),
        synthesize_trace(seed=9, n_requests=4, arrival="bursty",
                         burst_size=4, prompt_len=(8, 12),
                         output_len=(3, 5), vocab_size=97, rid_prefix="b"))
    runs = {}
    for dev in (card, torch.device("cpu")):
        model = load_numpy_state_dict(LlamaForCausalLM(cfg, device=dev),
                                      state)
        srv = llama_serving_decode_factory(
            model, max_len=64, page_size=16, n_pool_pages=17,
            batch_capacity=4, chunked_prefill=16, kv_quant=kv_quant,
            device=dev)
        for policy in ("routed", "dense", "paged"):
            tracer = Tracer()
            before = dict(tpa.paged_attention.instance_launches)
            res = ServingEngine(serving=srv, slots=4, policy=policy,
                                clock="fixed", trace=tracer).run(trace)
            steps = sum(e["args"].get("n", 1) for e in tracer.events
                        if e["ph"] == "X" and e["name"] == "decode")
            launched = {k: n - before[k] for k, n in
                        tpa.paged_attention.instance_launches.items()}
            runs[dev.type, policy] = (res, steps, launched)
    for policy in ("routed", "dense", "paged"):
        (got, steps, launched), (want, _, none) = (
            runs["cuda", policy], runs["cpu", policy])
        assert got.outputs == want.outputs
        if kv_quant is None:
            assert got.outputs == runs["cpu", "paged"][0].outputs
        assert got.slot_log == want.slot_log
        assert got.report() == want.report()
        assert launched == {"split": 2 * steps, "mma": 0, "rows": 0}
        assert none == {"split": 0, "mma": 0, "rows": 0}
    assert runs["cuda", "paged"][1] > 0 and runs["cuda", "dense"][1] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["least_loaded", "disaggregated"])
def test_serving_cluster_on_the_card_matches_the_cpu(card, placement):
    """Two replicas of a small f32 Llama (head_dim 64, pages of 16) behind
    ``ClusterRouter`` on the fixed clock, on the card and on the CPU, as
    chip_smoke.py's f32 cluster case runs them: under ``least_loaded``
    over two factories, and ``disaggregated`` with an int8 decode replica
    of 8-token pages (every handoff re-paged and transcoded). The same
    outputs, slot logs and censuses; on the card the least_loaded cluster
    equals a lone engine, and every decode step launches the split
    instance once a layer, over int8 pages on the int8 replica."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    readings, ok = smoke._cluster_small(card, (placement,))
    assert ok, readings["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("feature", ["lora", "grammar", "spec", "ragged"])
def test_serving_features_on_the_card_match_the_cpu(card, feature):
    """The engine's options on the fixed clock over a small f32 Llama's
    serving factory (head_dim 64), on the card and on the CPU: the same
    outputs and slot logs, the same streams as the plain engine for the
    rows the option leaves alone (adapter-free, grammar-free, every spec
    row, the ragged lane against the per-chunk lane); on the card every
    plain decode step launches the split instance once a layer, and the
    spec round, the ragged lane and prefill launch nothing (the page
    gather)."""
    import dataclasses

    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_serving_decode_factory,
                                             load_numpy_state_dict)
    from paddle_tpu_torch.obs import Tracer
    from paddle_tpu_torch.serving import (AdapterStore, GrammarStore,
                                          ServingEngine, SpecConfig,
                                          synthesize_lora_deltas,
                                          synthesize_schema_trace,
                                          synthesize_trace,
                                          synthesize_zipf_adapter_trace)

    cfg = LlamaConfig.tiny(vocab=97, hidden=256, layers=2, heads=4,
                           kv_heads=2)
    dcfg = LlamaConfig.tiny(vocab=97, hidden=128, layers=1, heads=2,
                            kv_heads=1)
    states = [{k: v.numpy() for k, v in
               LlamaForCausalLM(c, device="cpu", seed=s).state_dict()
               .items()} for c, s in ((cfg, 15), (dcfg, 16))]
    schemas = {"s0": {"type": "object", "properties": {
        "k0": {"type": "boolean"}}, "required": ["k0"]}}
    if feature == "lora":
        trace = synthesize_zipf_adapter_trace(
            seed=1, n_requests=8, n_adapters=2, base_frac=0.3,
            churn_frac=0.0, prompt_len=(5, 30), output_len=(3, 8),
            vocab_size=97)
        opts = dict(adapters=AdapterStore({f"a{k}": synthesize_lora_deltas(
            cfg, 4, seed=k + 1, init_scale=0.25) for k in range(2)}))
        build = dict(lora=(3, 4))
        free = [r.rid for r in trace if r.adapter is None]
    elif feature == "grammar":
        trace = synthesize_schema_trace(seed=4, n_requests=8, n_schemas=1,
                                        prompt_len=(4, 20),
                                        output_len=(16, 24), vocab_size=97)
        opts = dict(grammar=GrammarStore(schemas))
        build = dict(grammar=(2, 64))
        free = [r.rid for r in trace if r.schema is None]
    elif feature == "spec":
        trace = synthesize_trace(seed=0, n_requests=6, prompt_len=(4, 30),
                                 output_len=(4, 12), vocab_size=97,
                                 mean_interarrival=0.5)
        opts = dict(spec=SpecConfig(n_draft=3, accept_floor=0.0))
        build = dict(draft="draft")
        free = [r.rid for r in trace]
    else:
        trace = synthesize_trace(seed=5, n_requests=8, prompt_len=(4, 40),
                                 output_len=(3, 8), vocab_size=97,
                                 mean_interarrival=2.0)
        opts = dict(ragged_prefill=True, prefill_chunk_budget=2)
        build = {}
        free = [r.rid for r in trace]
    plain_trace = [dataclasses.replace(r, adapter=None, schema=None)
                   for r in trace]
    runs = {}
    for dev in (card, torch.device("cpu")):
        def factory(**kw):
            if kw.get("draft"):
                kw["draft"] = load_numpy_state_dict(
                    LlamaForCausalLM(dcfg, device=dev), states[1])
            return llama_serving_decode_factory(
                load_numpy_state_dict(LlamaForCausalLM(cfg, device=dev),
                                      states[0]),
                max_len=64, page_size=16, n_pool_pages=17,
                batch_capacity=4, chunked_prefill=16, device=dev, **kw)

        tracer = Tracer()
        before = dict(tpa.paged_attention.instance_launches)
        res = ServingEngine(serving=factory(**build), slots=4,
                            policy="paged", clock="fixed", trace=tracer,
                            **opts).run(trace)
        launched = {k: n - before[k] for k, n in
                    tpa.paged_attention.instance_launches.items()}
        steps = sum(e["args"].get("n", 1) for e in tracer.events
                    if e["ph"] == "X" and e["name"] == "decode")
        plain = ServingEngine(
            serving=factory(), slots=4, policy="paged", clock="fixed",
            **({"prefill_chunk_budget": 2} if feature == "ragged"
               else {})).run(plain_trace)
        runs[dev.type] = (res, launched, steps, plain)
    (got, launched, steps, plain), (want, none, _, _) = (runs["cuda"],
                                                          runs["cpu"])
    assert got.outputs == want.outputs and got.slot_log == want.slot_log
    assert free and all(got.outputs[rid] == plain.outputs[rid]
                        for rid in free)
    assert launched == {"split": 2 * steps, "mma": 0, "rows": 0}
    assert none == {"split": 0, "mma": 0, "rows": 0}
    if feature == "spec":
        assert got.spec_stats["rounds"] > 0 and steps == 0
    else:
        assert steps > 0


# --- GPT, the seq2seq Transformer and FusedMultiTransformer ----------------

def _decode_close(decoded, full):
    """Decode through caches against the no-cache forward, f32: the order
    of the sums only (one token's products against the sequence's), 1e-5
    absolute."""
    torch.testing.assert_close(decoded, full, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_gpt_on_the_card_matches_the_cpu(card):
    """GPT ``tiny()`` (hidden 64, 4 heads, 2 layers; the additive causal
    mask keeps it on the plain attention) from the same weights on the
    card and on the CPU: logits 1e-4, greedy tokens equal, 3 factory steps
    with losses 1e-5 and parameters at most 1e-4 of a tensor's elements
    (or one) beyond 1e-5 and none beyond lr; the key biases (noise
    gradients) within 2·3·lr. No kernel launches."""
    from paddle_tpu_torch.models.nlp import (GPTConfig, GPTForCausalLM,
                                             gpt_pretrain_step_factory,
                                             load_numpy_state_dict)

    torch.backends.cuda.matmul.allow_tf32 = False
    state = {k: v.numpy() for k, v in GPTForCausalLM(
        GPTConfig.tiny(), device="cpu").state_dict().items()}
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256,
                                                             (2, 49)))
    runs = {}
    for dev in (card, torch.device("cpu")):
        model = load_numpy_state_dict(GPTForCausalLM(GPTConfig.tiny(),
                                                     device=dev), state)
        before = fm.flash_attention.launches_fwd
        with torch.no_grad():
            logits = model(ids[:, :-1].to(dev)).cpu()
        tokens = model.generate(ids[:, :16].to(dev), 8).cpu()
        params, opt, step = gpt_pretrain_step_factory(
            model, learning_rate=1e-3, device=dev)
        losses = [float(step(params, opt, ids[:, :-1], ids[:, 1:])[2])
                  for _ in range(3)]
        assert fm.flash_attention.launches_fwd == before
        runs[dev.type] = (logits, tokens, losses,
                          {k: p.detach().cpu() for k, p in params.items()})
    (lg, tok, losses, params), (lg_c, tok_c, losses_c, params_c) = (
        runs["cuda"], runs["cpu"])
    torch.testing.assert_close(lg, lg_c, atol=1e-4, rtol=0)
    assert torch.equal(tok, tok_c)
    np.testing.assert_allclose(losses, losses_c, atol=1e-5, rtol=0)
    for k, p in params.items():
        diff = (p - params_c[k]).abs()
        if k.endswith("attn.k_proj.bias"):
            assert float(diff.max()) <= 6e-3, k
            continue
        assert int((diff > 1e-5).sum()) <= max(1, 1e-4 * diff.numel()), k
        assert float(diff.max()) <= 1e-3, k


@pytest.mark.cuda
def test_transformer_on_the_card_matches_the_cpu_and_decodes(card):
    """A small f32 ``nn.Transformer`` (d 128, 2 heads: head_dim 64 at
    S = 256 on both sides, 2 + 2 layers) from the same weights: the
    output under the causal target mask on the card (the encoder's and
    the cross-attention's multi-head flash kernels: one forward launch
    each a layer, and one dq and one dk/dv in the backward) within 1e-4
    of the CPU's (TF32 off); then a decode of 16 positions through
    ``TransformerDecoder``'s caches equal to that forward, on the card,
    without a kernel launch."""
    from paddle_tpu_torch.nn import Transformer, load_numpy_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(d_model=128, nhead=2, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=256, dropout=0.0)
    state = {k: v.numpy() for k, v in Transformer(
        **kw, device="cpu").state_dict().items()}
    rng = np.random.default_rng(4)
    src, tgt = (torch.from_numpy(rng.standard_normal((2, 256, 128))
                                 .astype(np.float32)) for _ in range(2))
    outs = {}
    for dev in (card, torch.device("cpu")):
        model = load_numpy_state_dict(Transformer(**kw, device=dev), state)
        mask = Transformer.generate_square_subsequent_mask(256, device=dev)
        counts = (fm.flash_attention.launches_fwd,
                  fm.flash_attention.launches_dq,
                  fm.flash_attention.launches_dkv)
        out = model(src.to(dev), tgt.to(dev), tgt_mask=mask)
        out.square().mean().backward()
        launched = tuple(n - b for n, b in zip(
            (fm.flash_attention.launches_fwd, fm.flash_attention.launches_dq,
             fm.flash_attention.launches_dkv), counts))
        assert launched == ((4, 4, 4) if dev.type == "cuda" else (0, 0, 0))
        outs[dev.type] = (model, out.detach())
    torch.testing.assert_close(outs["cuda"][1].cpu(), outs["cpu"][1],
                               atol=1e-4, rtol=0)
    model, full = outs["cuda"]
    before = fm.flash_attention.launches_fwd
    with torch.no_grad():
        memory = model.encoder(src.to(card))
        cache = model.decoder.gen_cache(memory)
        steps = []
        for t in range(16):
            step, cache = model.decoder(tgt[:, t:t + 1].to(card), memory,
                                        cache=cache)
            steps.append(step)
    assert fm.flash_attention.launches_fwd == before + 2   # the encoder
    _decode_close(torch.cat(steps, 1), full[:, :16])


@pytest.mark.cuda
def test_fused_multi_transformer_on_the_card_matches_the_cpu(card):
    """A small f32 ``FusedMultiTransformer`` (d 128, 4 heads, FFN 256, 2
    layers) from the same weights: the no-cache forward on the card
    within 1e-4 of the CPU's, and a token-by-token decode through the
    cache on the card equal to the card's forward; then in bf16 with the
    cache cast, finite and bf16."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.nn import load_numpy_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(embed_dim=128, num_heads=4, dim_feedforward=256, num_layers=2)
    state = {k: v.numpy() for k, v in FusedMultiTransformer(
        **kw, device="cpu").state_dict().items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 24, 128)).astype(np.float32))
    with torch.no_grad():
        want = load_numpy_state_dict(FusedMultiTransformer(
            **kw, device="cpu"), state)(x)
        model = load_numpy_state_dict(FusedMultiTransformer(
            **kw, device=card), state)
        full = model(x.to(card))
        torch.testing.assert_close(full.cpu(), want, atol=1e-4, rtol=0)
        cache = model.gen_cache(2, 32)
        steps = []
        for t in range(24):
            step, cache = model(x[:, t:t + 1].to(card), caches=cache,
                                time_step=t)
            steps.append(step)
        _decode_close(torch.cat(steps, 1), full)
        model.to(torch.bfloat16)
        cache = model.gen_cache(2, 32).to(torch.bfloat16)
        for t in range(4):
            step, cache = model(x[:, t:t + 1].to(card, torch.bfloat16),
                                caches=cache, time_step=t)
        assert step.dtype == torch.bfloat16 and bool(step.isfinite().all())


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["pressure", "hostmem", "ahead"])
def test_serving_tiers_on_the_card_match_the_cpu(card, part):
    """The pressure, host-memory and dispatch-ahead engines on the fixed
    clock over a small f32 Llama's serving factory (head_dim 64), as
    chip_smoke.py's reference phase runs them: the same outputs, slot
    logs, censuses and tier stats on the card and on the CPU; pages
    compacted, spilled, paged in and preempted; the host arena holds only
    pinned host tensors; dispatch-ahead equals the flag-off engine and
    serves turns from its stash."""
    readings, ok = _smoke()._reference_tiers(card, (part,))
    assert ok, readings


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 17, 32])
def test_int8_matmul_on_the_card_is_exact(card, rows):
    """``int8_matmul`` on the card (``torch._int_mm``, its operands padded
    to the sizes it takes) gives the bits of the CPU's exact int32
    product, at a decode step's 8 rows, at 17 and at 32, over inner and
    outer sizes that are not multiples of 8 too."""
    from paddle_tpu_torch.quantization import int8_matmul, quantize_stacked

    rng = np.random.default_rng(rows)
    for K, N in ((4096, 1024), (100, 36)):
        x = torch.from_numpy(rng.standard_normal((rows, K))
                             .astype(np.float32)).to(torch.bfloat16)
        q, s = quantize_stacked(torch.from_numpy(
            rng.standard_normal((K, N)).astype(np.float32)))
        want = int8_matmul(x, q, s)
        got = int8_matmul(x.to(card), q.to(card), s.to(card))
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["int8", "rolling", "spec"])
def test_decode_options_on_the_card_match_the_cpu(card, part):
    """int8 weights with the int8 cache, the rolling cache and the
    speculative factory on small f32 Llamas, card against CPU from the
    same weights, as chip_smoke.py's reference phase runs them: the same
    greedy tokens, teacher-forced logits within 1e-4, and speculative
    tokens and stats equal, and equal to plain greedy."""
    readings, ok = _smoke()._reference_decode_options(card, (part,))
    assert ok, readings


def _eager_bert_run(dev, level, state, batch, steps=3, lr=1e-4):
    """A tiny BERT (hidden 64, S = 32: the plain attention) trained by
    the everyday loop on ``dev`` with chip_smoke.py's train_eager
    optimizer, schedule, clip and GradScaler: (losses, parameters on the
    CPU)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.models.nlp import (BertConfig, BertForPretraining,
                                             load_numpy_state_dict)

    model = load_numpy_state_dict(BertForPretraining(BertConfig.tiny(),
                                                     device=dev), state)
    sched = optimizer.lr.LinearWarmup(
        optimizer.lr.PolynomialDecay(lr, 1000, 0.0), 2, 0.0, lr)
    opt = optimizer.AdamW(learning_rate=sched,
                          parameters=model.parameters(), weight_decay=0.01,
                          grad_clip=pnn.ClipGradByGlobalNorm(1.0))
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15,
                            enable=level is not None)
    ids, types, mlm, nsp = (t.to(dev) for t in batch)
    losses = []
    for _ in range(steps):
        with amp.auto_cast(enable=level is not None, level=level or "O1"):
            loss = model.loss(*model(ids, types), mlm, nsp)
        scaled = scaler.scale(loss)
        scaled.backward()
        scaler.minimize(opt, scaled)
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.detach()))
    return losses, {k: p.detach().float().cpu()
                    for k, p in model.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("level", [None, "O1"], ids=["f32", "O1"])
def test_eager_bert_loop_on_the_card_matches_the_cpu(card, level):
    """The eager slice card against CPU from the same weights and batch:
    f32 by the TRAIN_REF rule (losses 1e-5; at most 1e-4 of a tensor's
    elements, or one, beyond 1e-5, none beyond lr); O1 (bf16 forward on
    both) losses within 1e-2 relative and parameters within 2·3·lr; the
    key biases (noise gradients) within 2·3·lr."""
    from paddle_tpu_torch.models.nlp import BertConfig, BertForPretraining

    torch.backends.cuda.matmul.allow_tf32 = False
    state = {k: v.numpy() for k, v in BertForPretraining(
        BertConfig.tiny(), device="cpu").state_dict().items()}
    rng = np.random.default_rng(3)
    batch = [torch.from_numpy(rng.integers(0, 512, (2, 32))),
             torch.from_numpy((np.arange(32) >= 16).astype(np.int64)[None]
                              .repeat(2, 0)),
             torch.from_numpy(np.where(rng.random((2, 32)) < 0.3,
                                       rng.integers(0, 512, (2, 32)),
                                       -100)),
             torch.from_numpy(rng.integers(0, 2, (2,)))]
    losses, params = _eager_bert_run(card, level, state, batch)
    losses_c, params_c = _eager_bert_run(torch.device("cpu"), level, state,
                                         batch)
    print(level, "losses", losses, losses_c)
    if level is None:
        np.testing.assert_allclose(losses, losses_c, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(losses, losses_c, rtol=1e-2, atol=0)
    for k, p in params.items():
        diff = (p - params_c[k]).abs()
        if level is not None or k.endswith("attn.k_proj.bias"):
            assert float(diff.max()) <= 6e-4, k
            continue
        assert int((diff > 1e-5).sum()) <= max(1, 1e-4 * diff.numel()), k
        assert float(diff.max()) <= 1e-4, k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "AdamW",
                                  "Adamax", "Adagrad", "RMSProp",
                                  "Adadelta", "Lamb"])
def test_optimizer_steps_on_the_card_match_the_cpu(card, name):
    """Each optimizer's 3 steps (weight decay 0.01, the global-norm clip)
    on the card against the CPU on the same parameters and gradients:
    parameters and accumulators within 1e-5 relative + 1e-6 absolute
    (the card's fused multiply-adds and its norm's order of sums; worst
    reading Adagrad, one element of 2048 1.76e-6 apart, 4.0e-6
    relative)."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer

    rng = np.random.default_rng(0)
    shapes = [(64, 32), (32,), (4, 8, 3)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    decay = "lamb_weight_decay" if name == "Lamb" else "weight_decay"
    runs = {}
    for dev in (card, torch.device("cpu")):
        ps = [torch.nn.Parameter(torch.from_numpy(a).to(dev)) for a in init]
        opt = getattr(optimizer, name)(
            learning_rate=0.01, parameters=ps, **{decay: 0.01},
            grad_clip=pnn.ClipGradByGlobalNorm(1.0))
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g).to(dev)
            opt.step()
        runs[dev.type] = ([p.detach().cpu() for p in ps],
                          [{k: a.cpu() for k, a in
                            opt._accumulators[id(p)].items()} for p in ps])
    (ps, accs), (ps_c, accs_c) = runs["cuda"], runs["cpu"]
    for a, b in zip(ps, ps_c):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(accs, accs_c):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_block_sparse_attention_kernels_match_plain(card, causal):
    """``F.block_sparse_attention`` (B=2, S=512, 4 heads, head_dim 64,
    bf16, 64 x 64 blocks, a random mask with an empty block row) through
    the splash kernels, one launch of each, against its plain versions:
    output and q / k / v gradients within chip_smoke.py's bf16 limits
    (2e-3 + 2^-6·|want|); the empty rows exactly 0."""
    from paddle_tpu_torch.nn import functional as F

    sa = importlib.import_module("paddle_tpu_torch.ops.splash_attention")
    rng = np.random.default_rng(1)
    bm = rng.random((8, 8)) < 0.5
    bm[:, 0] = True
    bm[3] = False
    g = torch.Generator(device=card).manual_seed(2)
    q, k, v, do = (torch.randn((2, 512, 4, 64), generator=g, device=card)
                   .to(torch.bfloat16) for _ in range(4))

    def run():
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.block_sparse_attention(*ts, bm, causal, 64, 64)
        return (out.detach(), *torch.autograd.grad(out, ts, do))

    owner = sa.splash_attention
    before = (owner.launches_fwd, owner.launches_dq, owner.launches_dkv)
    got = run()
    assert (owner.launches_fwd, owner.launches_dq, owner.launches_dkv) == \
        tuple(n + 1 for n in before)
    kept = sa.splash_fwd, sa.splash_bwd
    sa.splash_fwd, sa.splash_bwd = sa._splash_fwd_plain, sa._splash_bwd_plain
    try:
        want = run()
    finally:
        sa.splash_fwd, sa.splash_bwd = kept
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-3,
                                   rtol=2 ** -6)
    assert not got[0][:, 3 * 64:4 * 64].any()


@pytest.mark.cuda
def test_op_sweep_on_the_card_matches_the_cpu(card):
    """Every case of ``torch_op_cases.py`` (every op of the namespace)
    through the port on the card against the port on the CPU, as
    chip_smoke.py's reference phase runs it: values within each case's
    tolerance, gradients within 1e-5 + 1e-5 rel, and each random op's
    draws equal from one seed on the card."""
    readings, failures = _smoke().op_sweep(card)
    assert not failures, readings


@pytest.mark.cuda
def test_rnns_and_beam_search_on_the_card_match_the_cpu(card):
    """2-layer bidirectional LSTM / GRU / SimpleRNN stacks in both
    ``time_major`` forms within 1e-5, the small LM's 3 SGD steps under
    ``TRAIN_REF`` and its beam ids equal, card against CPU."""
    readings = _smoke()._reference_rnn(card)
    assert readings["rnn_ok"], readings


@pytest.mark.cuda
def test_exported_program_launches_the_flash_kernel(card, tmp_path):
    """A classifier saved by ``jit.save`` (symbolic batch) and loaded: its
    program holds one ``gqa_fwd`` node a layer, and running it launches
    the multi-head flash forward kernel once a layer, counted by the
    operator's CUDA implementation. Its logits equal eager mode's bit for
    bit (the same operators in the same order) and the plain CPU
    forward's within 1e-4 (f32, the kernel's sums in another order)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import flash_attention as fm

    paddle.set_device("gpu")
    nn = paddle.nn
    L, S = 2, 256

    class Classifier(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(97, 64)
            self.encoder = nn.TransformerEncoder(
                nn.TransformerEncoderLayer(64, 1, 128, dropout=0.0), L)
            self.head = nn.Linear(64, 3)

        def forward(self, ids):
            return self.head(paddle.mean(self.encoder(self.embed(ids)),
                                         axis=1))

    paddle.seed(0)
    net = Classifier()
    net.eval()
    path = str(tmp_path / "c")
    paddle.jit.save(net, path,
                    input_spec=[paddle.jit.InputSpec([None, S], "int64")])
    layer = paddle.jit.load(path)
    fwd = torch.ops.paddle_tpu_torch.gqa_fwd.default
    assert sum(n.target is fwd for n in layer.program.graph.nodes) == L
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 97, (3, S))
                           ).to(card)
    before = fm.flash_attention.launches_fwd
    got = layer(ids)
    torch.cuda.synchronize()
    assert fm.flash_attention.launches_fwd == before + L
    with torch.no_grad():
        assert torch.equal(got, net(ids))
        cpu = net.to("cpu")(ids.cpu())
    assert float((got.cpu() - cpu).abs().max()) <= 1e-4


def _dy2static_fn(x, n):
    s = x * 0
    i = 0
    while i < n:
        s = s + x
        if s.sum() > 100:
            break
        i = i + 1
    if s.sum() > 0:
        s = s * 2
    else:
        s = -s
    return s


@pytest.mark.cuda
def test_dy2static_captures_control_flow_on_the_card(card):
    """A tensor ``while`` with a tensor ``break`` and a tensor ``if``
    under ``jit.to_static`` on card tensors: the program holds
    ``while_loop`` and ``cond`` (the card's PyTorch traces their bodies
    with dynamo), and its outputs equal eager mode's bit for bit."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    sf = paddle.jit.to_static(_dy2static_fn)
    x = torch.randn(4, 8, device=card)
    for a, n in ((x, 3), (-x, 5), (x.abs() * 10, 7)):
        n = torch.tensor(n, device=card)
        assert torch.equal(sf(a, n), _dy2static_fn(a, n))
    names = {getattr(nd.target, "__name__", str(nd.target))
             for m in sf.concrete_program.graph_module.modules()
             if isinstance(m, torch.fx.GraphModule)
             for nd in m.graph.nodes if nd.op == "call_function"}
    assert {"cond", "while_loop"} <= names
    assert sf.cache_stats()["compiles"] == 1


@pytest.mark.cuda
def test_static_program_on_the_card_matches_eager(card):
    """A 1-layer encoder (d 128, 2 heads of 64) at S=512 as a static
    program with a -1 batch, replayed by ``static.Executor`` on the card:
    the logits, the loss and the gradients of every parameter and of the
    embedded input equal the eager forward and backward's on the card
    bit for bit (the same ops in the same order), and the multi-head
    flash forward, dq and dk/dv launch as often as eagerly (once each)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import flash_attention as fm

    paddle.set_device("gpu")
    nn = paddle.nn
    S = 512
    paddle.seed(0)
    enc = nn.TransformerEncoder(
        nn.TransformerEncoderLayer(128, 2, 256, dropout=0.0), 1)
    head = nn.Linear(128, 3)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, S, 128)).astype("f4")
                         ).to(card)
    label = torch.from_numpy(rng.integers(0, 3, (2, 1))).to(card)
    params = list(enc.parameters()) + list(head.parameters())
    counter = fm.flash_attention

    def launches():
        return (counter.launches_fwd, counter.launches_dq,
                counter.launches_dkv)

    paddle.enable_static()
    try:
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            xv = paddle.static.data("x", [-1, S, 128], "float32")
            lv = paddle.static.data("label", [-1, 1], "int64")
            logits = head(paddle.mean(enc(xv), axis=1))
            loss = paddle.nn.CrossEntropyLoss()(logits, lv)
            pairs = paddle.static.append_backward(loss)
            grads = [g for _, g in pairs]
            gx, = paddle.static.gradients(loss, [xv])
        exe = paddle.static.Executor(paddle.CUDAPlace(0))
        before = launches()
        got = exe.run(main, feed={"x": x, "label": label},
                      fetch_list=[logits, loss] + grads + [gx],
                      return_numpy=False)
        torch.cuda.synchronize()
        static_launches = [a - b for a, b in zip(launches(), before)]
    finally:
        paddle.disable_static()
    xe = x.clone().requires_grad_(True)
    before = launches()
    e_logits = head(paddle.mean(enc(xe), axis=1))
    e_loss = paddle.nn.CrossEntropyLoss()(e_logits, label)
    assert {id(p) for p, _ in pairs} == {id(p) for p in params}
    want = [e_logits, e_loss] + list(torch.autograd.grad(
        e_loss, [p for p, _ in pairs] + [xe]))
    torch.cuda.synchronize()
    eager_launches = [a - b for a, b in zip(launches(), before)]
    assert static_launches == eager_launches == [1, 1, 1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w.detach())


@pytest.mark.cuda
def test_mesh_factory_on_the_card_matches_one_device(card, tmp_path):
    """Four gloo ranks on the one card train a small f32 Llama (hidden
    256, 4 / 2 heads, S=256: the grouped flash kernels on each rank's
    heads) on {data 2, model 2} and {data 2, sharding 2}: 3 losses within
    1e-5 relative of the factory on one device (the same weights and
    batch)."""
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import torch_dist_ranks as R
    from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.nlp.llama import llama_train_step_factory

    cfg = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, dtype=torch.float32)
    model = LlamaForCausalLM(LlamaConfig(**cfg), device=card, seed=3)
    state = {k: v.detach().cpu().numpy()
             for k, v in model.state_dict().items()}
    rng = np.random.default_rng(4)
    tokens, labels = (rng.integers(0, 256, (4, 256)) for _ in range(2))
    params, opt, step = llama_train_step_factory(model, learning_rate=1e-3,
                                                 remat=False)
    want = [float(step(params, opt, tokens, labels)[2]) for _ in range(3)]
    runs = {name: (name, "llama_mesh", dict(dims=dims, cfg=cfg, state=state,
                                            tokens=tokens, labels=labels))
            for name, dims in (("dm", {"data": 2, "model": 2}),
                               ("ds", {"data": 2, "sharding": 2}))}
    ranks = R.run_world(tmp_path, 4, list(runs.values()), device="gpu")
    for name in runs:
        for r in ranks:
            got = r[name]
            assert "error" not in got, got.get("error")
            np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    assert all(tuple(r["dm"]["engaged"]["heads"]) == (2, 1) for r in ranks)


@pytest.mark.cuda
def test_two_rank_ring_on_the_card_matches_the_plain_version(card, tmp_path):
    """Two gloo ranks on the one card: ``ring_attention`` (causal, G = 2,
    the grouped flash kernels per chunk), ``ring_window_attention`` (the
    splash kernels at q_offset S/2) and ``ulysses_attention`` (the
    multi-head kernels over the whole sequence) at S/2 = 256, f32, each
    rank's output chunk within 1e-5 and its q / k / v gradients within
    1e-4 (relative and absolute: the kernel phase's f32 tolerances) of the
    same ring over the plain versions on the CPU (K/V staged through host
    memory on the card); the launches each rank's chunks call for: rank 1
    runs the causal ring's two chunks, rank 0 one."""
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import torch_dist_ranks as R

    def case(kind, Hq, Hkv, causal=True, window=None, seed=0):
        rng = np.random.default_rng(seed)
        S, D = 512, 64
        return dict(kind=kind, dims={"sep": 2}, causal=causal, window=window,
                    **{x: rng.standard_normal((1, h, S, D)).astype(np.float32)
                       for x, h in (("q", Hq), ("k", Hkv), ("v", Hkv),
                                    ("do", Hq))})

    cases = {"ring": case("ring", 4, 2), "window": case("window", 4, 2,
                                                        window=300, seed=1),
             "ulysses": case("ulysses", 4, 4, seed=2)}
    ranks = R.run_world(tmp_path, 2, [
        ("card", "sep_attention", dict(cases=cases, device="cuda")),
        ("cpu", "sep_attention", dict(cases=cases, device="cpu"))],
        device="gpu")
    want_launches = {
        "ring": [{"gqa_fwd": 1, "gqa_dq": 1, "gqa_dkv": 1},
                 {"gqa_fwd": 2, "gqa_dq": 2, "gqa_dkv": 2}],
        "window": [{"splash_fwd": 1, "splash_dq": 1, "splash_dkv": 1},
                   {"splash_fwd": 2, "splash_dq": 2, "splash_dkv": 2}],
        "ulysses": [{"mha_fwd": 1, "mha_dq": 1, "mha_dkv": 1}] * 2}
    for r in ranks:
        for part in ("card", "cpu"):
            assert "error" not in r[part], r[part].get("error")
        for name in cases:
            got, want = r["card"][name], r["cpu"][name]
            assert got["launches"] == want_launches[name][got["sep"]], name
            assert want["launches"] == {}
            for key in ("out", "dq", "dk", "dv"):
                err = float(np.abs(got[key] - want[key]).max())
                print(f"ring on the card: {name} {key} max |err| {err:.3g}")
                tol = 1e-5 if key == "out" else 1e-4
                np.testing.assert_allclose(got[key], want[key], rtol=tol,
                                           atol=tol, err_msg=(name, key))


@pytest.mark.cuda
def test_two_rank_sync_batch_norm_and_expert_layer_on_the_card(card,
                                                               tmp_path):
    """Two gloo ranks on the one card, bf16: ``nn.SyncBatchNorm`` over the
    world on each rank's half of the batch against ``BatchNorm2D`` on the
    whole batch on one device (each rank's output and x gradient rows,
    the weight and bias gradients summed over the ranks, the running
    statistics on every rank), and a ``MoELayer`` spread over {expert 2}
    (each rank 2 of the 4 experts) against the whole layer on one
    device (output, x and router gradients). Tolerance 2e-2 absolute and
    relative: bf16 roundings of partial sums (the statistics' and the
    experts' partial outputs) that one device rounds once."""
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import torch_dist_ranks as R
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

    rng = np.random.default_rng(0)
    bn = {"x": rng.standard_normal((8, 16, 6, 6)).astype(np.float32) * 2
          + 1, "dout": rng.standard_normal((8, 16, 6, 6)).astype(np.float32)}
    H, F, E = 64, 128, 4
    ref_layer = MoELayer(H, F, E, device="cpu")
    moe = {"H": H, "F": F, "E": E, "x": rng.standard_normal(
        (2, 16, H)).astype(np.float32), "dout": rng.standard_normal(
        (2, 16, H)).astype(np.float32),
        "state": {k: v.numpy() for k, v in ref_layer.state_dict().items()}}
    ranks = R.run_world(tmp_path, 2, [
        ("card", "card_sync_layers", dict(bn=bn, moe=moe, device="cuda"))],
        device="gpu")
    bf16 = torch.bfloat16
    layer = nn.BatchNorm2D(16, device="cuda").to(bf16)
    x = torch.from_numpy(bn["x"]).to(card, bf16).requires_grad_(True)
    y = layer(x)
    (y * torch.from_numpy(bn["dout"]).to(card, bf16)).sum().backward()
    want = {k: v.detach().float().cpu().numpy() for k, v in dict(
        out=y, dx=x.grad, dw=layer.weight.grad, db=layer.bias.grad,
        mean=layer._mean, var=layer._variance).items()}
    one = MoELayer(H, F, E, device="cuda")
    nn.load_numpy_state_dict(one, moe["state"])
    one = one.to(bf16).eval()
    xm = torch.from_numpy(moe["x"]).to(card, bf16).requires_grad_(True)
    ym = one(xm)
    ((ym * torch.from_numpy(moe["dout"]).to(card, bf16)).sum()
     + one.aux_loss).backward()
    want_moe = {k: v.detach().float().cpu().numpy() for k, v in dict(
        out=ym, dx=xm.grad, dwg=one.gate.wg.weight.grad).items()}
    tol = dict(rtol=2e-2, atol=2e-2)
    got = [r["card"] for r in ranks]
    for g in got:
        assert "error" not in g, g.get("error")
    for key in ("out", "dx"):
        np.testing.assert_allclose(
            np.concatenate([g["bn"][key] for g in got]), want[key], **tol,
            err_msg=key)
    for key in ("dw", "db"):
        np.testing.assert_allclose(sum(g["bn"][key] for g in got),
                                   want[key], **tol, err_msg=key)
    for g in got:
        for key in ("mean", "var"):
            np.testing.assert_allclose(g["bn"][key], want[key], **tol)
            np.testing.assert_array_equal(g["bn"][key], got[0]["bn"][key])
        for key in ("out", "dx", "dwg"):
            err = float(np.abs(g["moe"][key] - want_moe[key]).max())
            print(f"expert layer on the card: {key} max |err| {err:.3g}")
            np.testing.assert_allclose(g["moe"][key], want_moe[key], **tol,
                                       err_msg=key)
