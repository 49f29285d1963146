#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card: the quickest proof that the port still builds, is right, serves and
trains.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases build,kernel
    python3 chip_smoke.py --phases build,kernel,train

Phases, each printing JSON lines:

1. ``build``: compile every kernel under ``paddle_tpu_torch/ops/kernels``
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel).
2. ``kernel``: each kernel through its wrapper at the shapes of the main
   paths, against its plain version on the same inputs, element by
   element within the stated tolerance; each call must launch its kernel
   once. Times are CUDA events (median of ``REPS``, L2 flushed before each
   call) beside the bound (the least time the card could take: the bytes
   that must move at 3.35 TB/s, the operations at the data sheet's peak
   for their type) and, where one PyTorch call computes the same function,
   that call's time (a yardstick, never on the port's path).
   * paged attention (``paged_attention``, ``paged_prefill_attention``)
     at the serving shapes of Llama-3-8B (32 query / 8 kv heads, head_dim
     128, page 64): decode at B=8 with ragged lengths 1..2048 and one pad
     row of length 0, and a 256-token prefill chunk at starts 0 and 512;
     q in bf16, pools in bf16 and in int8 with per-slot scales;
   * grouped flash attention (``gqa_fwd``; ``gqa_bwd``: the dq and dkv
     kernels) at the training shapes of Llama-3-8B: B=2, 32 query / 8 kv
     heads, S=4096, head_dim 128, bf16, causal; and at head_dim 64, f32,
     S=256 (the reference phase's shapes). Yardstick:
     ``F.scaled_dot_product_attention(..., is_causal=True,
     enable_gqa=True)`` forward, and its backward alone;
   * fused cross-entropy (``ce_fwd``, ``ce_bwd``) at N=8192 rows of
     V=128256 bf16 logits, int64 labels. Yardstick: ``F.cross_entropy(...,
     reduction="none")`` forward, and its backward alone.
   This phase runs before any model is on the card: the plain attention at
   S=4096 holds 4.3 GB score tensors.
3. ``reference``: a small f32 Llama (hidden 256, 4 / 2 heads, head_dim 64,
   2 layers) through the port on the card (the kernels) and on the CPU
   (the plain versions), from the same weights: greedy decode tokens
   identical and logits within ``REF_ATOL``; then the train step at B=2,
   S=256: the losses of 3 steps, every gradient of step 1 and every
   parameter after step 3.
4. ``serve``: Llama-3-8B at full width and depth, bf16, random weights
   from a seed, through ``examples/serve_paged_llama.serve``: 16 requests,
   continuous batching in 8 slots of 2048 tokens, chunked prefill of 256
   tokens through the kernel, fixed-shape decode steps with pad rows on
   the reserved page 0. The kernel's launch count is set to 0 just before
   and read just after, and must equal the launches the run implies. Then
   one decode step runs with the kernel and with the plain version on
   identical pools, and their logits are compared. With ``--profile``, a
   ``torch.profiler`` trace of decode steps splits the step's device time
   into the attention kernel, matrix products and the rest.
5. ``train``: Llama-3-8B at full width with 8 of its 32 layers (the cut
   that lets params, grads and AdamW moments fit one 80 GB card), bf16,
   random weights from a seed, B=2, S=4096, through
   ``examples/train_llama_compiled.train``: 5 AdamW steps (lr 1e-3) on one
   fixed batch. First, one forward and backward with the kernels and one
   with their plain versions on identical weights: the loss difference
   and each parameter's relative gradient error; one more with the
   kernels is timed alone (``fwd_bwd_ms``: a step less its AdamW update,
   on the host clock). Then the launch counts
   are set to 0, the 5 steps run, and the counts must be 8 forward, 8 dq
   and 8 dkv GQA launches and 1 + 1 CE launches per step; every loss must
   be finite and the last below the first. With ``--profile``, a
   ``torch.profiler`` trace splits a train step into the GQA kernels, the
   CE kernels, matrix products and the rest, with the rest's costliest
   kernels by name.

Then the card's name and power limit, the ``kernels`` line, and, last,
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result line. Without CUDA it exits at once.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
REPS = 25
# kernel vs plain on the same bf16 inputs: both sum in f32 (apart by
# ~1e-6 from the order of the sum) and round the output to bf16 once, so
# an element may land one bf16 ulp apart: at most 2^-7 of |want|. The
# atol covers the f32 order near 0. Largest reading: 3.9e-3 at |want|
# near 1, i.e. one ulp (PERF.md, metrics table).
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 2 ** -7
# f32 model, card (kernel, cuBLAS in full f32) vs CPU (plain, MKL):
# summation order only
REF_ATOL = 1e-4
# 8B decode step, kernel vs plain attention on identical pools: one bf16
# rounding apart per layer, carried through 32 bf16 layers. Reading
# 0.238 (max |logit| 6.19); the limit is about twice it.
STEP_ATOL = 0.5

# grouped flash attention, kernel vs plain on the same inputs. bf16: the
# same roundings (q2, probabilities, ds) on f32 sums in another order, and
# the forward's online softmax rounds each probability against the running
# max rather than the final one: an element may land a bf16 ulp or two
# apart. Readings at the training shapes (S=4096): err/limit 0.64 (out),
# 0.51 (dq), 0.46 (dk, dv). f32: order of the sums only (readings 6e-6).
GQA_TOL = {"bfloat16": dict(out=(2e-3, 2 ** -6), grad=(2e-3, 2 ** -6)),
           "float32": dict(out=(1e-5, 1e-5), grad=(1e-4, 1e-4))}
LSE_TOL = (1e-5, 1e-5)
# fused CE: loss and lse are f32 sums in another order (readings 2e-6);
# dx rounds the same f32 value to bf16 once: one ulp at most, 2^-7 of
# |want| at any size (dx is (p - onehot) / N, down to 1e-14)
CE_TOL = dict(loss=(1e-5, 1e-5), dx=(1e-12, 2 ** -7))
# tiny f32 train step, card vs CPU: order of the sums only. AdamW moves a
# weight by about lr whatever its gradient's size, so where a gradient is
# as small as its f32 noise the two may step differently: at most 1e-4 of
# a parameter's elements beyond 1e-5, none beyond lr (the same rule as
# tests/test_torch_train_step.py against the JAX package).
TRAIN_REF = dict(loss=1e-5, grad=1e-5, param=1e-5, param_frac=1e-4,
                 lr=1e-3)
# 8-layer 8B bf16 forward+backward, kernels vs plain versions on
# identical weights: bf16 roundings apart in every layer (the forward
# kernel rounds each probability against the running max, the plain
# version against the final one), carried through 8 bf16 layers into
# logits whose bf16 ulp is ~0.005. Readings: loss 2.1e-4 apart (of 12.57;
# 1.7e-5 relative); ||g_kernel - g_plain|| / ||g_plain|| 0.031 (median
# over parameters; lm_head 0.022) to 0.053 (layer 7 k_proj). Limits about
# twice the readings.
TRAIN_LOSS_ATOL = 5e-4
TRAIN_GRAD_REL = 0.1
TRAIN_LAYERS = 8

SOURCE = "paddle_tpu_torch/ops/kernels/paged_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:46"
GQA_SOURCE = "paddle_tpu_torch/ops/kernels/flash_attention_gqa.cu"
CE_SOURCE = "paddle_tpu_torch/ops/kernels/fused_ce.cu"
GQA_FWD_REPLACES = "paddle_tpu/ops/pallas/flash_attention_gqa.py:131"
GQA_BWD_REPLACES = "paddle_tpu/ops/pallas/flash_attention_gqa.py:177,216"
CE_FWD_REPLACES = "paddle_tpu/ops/pallas/fused_ce.py:33"
CE_BWD_REPLACES = "paddle_tpu/ops/pallas/fused_ce.py:45"


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_ms(fn, reps=REPS, flush=None):
    """Median device time of ``fn()`` in ms. Before each call the L2 is
    flushed and the stream is held busy by a spin kernel, so the host's
    enqueue of ``fn`` overlaps it and the events time the device alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# --- phase 1: build --------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, log in logs.items():
        if log.strip():
            print(f"[nvcc {name}]\n{log}", file=sys.stderr)
    emit({"phase": "build", "ok": True, "sources": _build.sources(),
          "seconds": time.perf_counter() - t0})


# --- phase 2: the kernel against its plain version --------------------------

def _kernel_case(name, B, Hkv, G, D, ps, W, P, lens, start, C, kv_dtype,
                 seed, dev, flush):
    """One call of the port's wrapper at the given shapes, as the serving
    path makes it: ``paged_attention`` for decode (``start`` None, q
    (B, Hq, D)), ``paged_prefill_attention`` for a C-token chunk at
    ``start`` (q (B, Hq, C, D)). Held against ``paged_attention_reference``
    on the same inputs (error and times), beside the bound of the work its
    data needs."""
    # the package re-exports the function under the module's name
    pa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")

    g = torch.Generator(device=dev).manual_seed(seed)
    rows = G * C
    q_shape = (B, Hkv * G, D) if start is None else (B, Hkv * G, C, D)
    q = torch.randn(q_shape, generator=g, device=dev).to(torch.bfloat16)
    if kv_dtype == "int8":
        k = torch.randint(-127, 128, (Hkv, P, ps, D), generator=g,
                          device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (Hkv, P, ps, D), generator=g,
                          device=dev, dtype=torch.int8)
        ks = torch.rand((Hkv, P, ps), generator=g, device=dev) * 0.02
        vs = torch.rand((Hkv, P, ps), generator=g, device=dev) * 0.02
        kv_bytes = 1 + 4 / D      # a code per element, a scale per slot
    else:
        k = torch.randn((Hkv, P, ps, D), generator=g, device=dev) \
            .to(torch.bfloat16)
        v = torch.randn((Hkv, P, ps, D), generator=g, device=dev) \
            .to(torch.bfloat16)
        ks = vs = None
        kv_bytes = 2
    scales = {} if ks is None else {"k_scales": ks, "v_scales": vs}
    # distinct pages for every live sequence, from 1 up (page 0 reserved)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        seed))[:B * W] + 1
    pt = perm.reshape(B, W).to(torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    pt[lens_t == 0] = 0                    # a pad row points at page 0
    pt, lens_t = pt.to(dev), lens_t.to(dev)

    if start is None:
        def kernel():
            return pa.paged_attention(q, k, v, pt, lens_t, **scales)
    else:
        def kernel():
            return pa.paged_prefill_attention(q, k, v, pt, lens_t, start,
                                              **scales)

    def plain():
        return pa.paged_attention_reference(q, k, v, pt, lens_t, **scales,
                                            q_start=start)

    before = pa.paged_attention.launches
    got = kernel()
    launched = pa.paged_attention.launches - before
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    allowed = KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
    ok = launched == 1 and bool(torch.all(err <= allowed))
    if lens.count(0):
        ok = ok and not got[[i for i, n in enumerate(lens) if n == 0]].any()
    ms = gpu_ms(kernel, flush=flush)
    plain_ms = gpu_ms(plain, flush=flush)

    # the work this data needs: the live keys of each row, K and V of each
    # live slot read once, q read once, out written once
    st = [max(n - 1, 0) for n in lens] if start is None else [start] * B
    pairs = live_slots = live_pages = 0
    for b, n in enumerate(lens):
        pos = [st[b] + c for c in range(C)]
        pairs += G * Hkv * sum(min(p + 1, n) for p in pos)
        keys = min(n, pos[-1] + 1)
        live_slots += Hkv * keys
        live_pages += -(-keys // ps)
    bytes_ = (2 * live_slots * D * kv_bytes          # K and V
              + 2 * q.numel() * 2                    # q in, out back
              + 4 * (live_pages + B))                # page ids, lens
    flops = 4 * D * pairs                            # q.k and p.v
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"case": name, "ok": ok, "max_abs_err": float(err.max()),
            # the largest error over its limit, element by element
            "max_err_over_tol": float((err / allowed).max()),
            "atol": KERNEL_ATOL, "rtol": KERNEL_RTOL,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(bytes_), "flops": int(flops),
            "shape": {"B": B, "Hkv": Hkv, "rows": rows, "D": D, "ps": ps,
                      "W": W, "P": P, "q": "bfloat16", "kv": kv_dtype}}


def _check(got, want, atol, rtol, chunk=1 << 27):
    """(max abs error, largest error / limit) of ``got`` against ``want``
    element by element, limit = atol + rtol * |want|; in chunks, so a
    2 GB tensor needs no 8 GB of f32 temporaries."""
    g, w = got.reshape(-1), want.reshape(-1)
    max_err = ratio = 0.0
    for i in range(0, g.numel(), chunk):
        gf, wf = g[i:i + chunk].float(), w[i:i + chunk].float()
        err = (gf - wf).abs()
        max_err = max(max_err, float(err.max()))
        ratio = max(ratio, float((err / (atol + rtol * wf.abs())).max()))
    return max_err, ratio


def _bound(bytes_, flops, flop_rate):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(bytes_), "flops": int(flops)}


def _gqa_case(name, B, Hkv, G, S, D, dtype, causal, seed, dev, flush):
    """The forward kernel through ``gqa_fwd`` and the dq and dkv kernels
    through ``gqa_bwd`` (on the plain forward's lse and delta, so each
    kernel meets its plain version on the same inputs), at the given
    shapes; then times: each kernel, the plain versions, and SDPA's
    forward and backward as the yardstick."""
    import torch.nn.functional as F

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention_gqa")
    gfa = fa.grouped_flash_attention
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((B, Hkv * G, S, D), generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, Hkv, S, D), generator=g, device=dev).to(dt)
            for _ in range(2))
    scale = 1.0 / D ** 0.5

    def counts():
        return gfa.launches_fwd, gfa.launches_dq, gfa.launches_dkv

    n0 = counts()
    out, lse = fa.gqa_fwd(q, k, v, causal)
    n1 = counts()
    want_out, want_lse = fa._gqa_fwd_plain(q, k, v, causal)
    delta = (do.float() * want_out.float()).sum(-1)
    grads = fa.gqa_bwd(q, k, v, do, want_lse, delta, causal)
    n2 = counts()
    want_grads = fa._gqa_bwd_plain(q, k, v, do, want_lse, delta, causal)
    torch.cuda.synchronize()
    tol = GQA_TOL[dtype]
    checks = {"out": _check(out, want_out, *tol["out"]),
              "lse": _check(lse, want_lse, *LSE_TOL)}
    for n, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        checks[n] = _check(a, b, *tol["grad"])
    launched = (n1 == (n0[0] + 1, n0[1], n0[2])
                and n2 == (n1[0], n1[1] + 1, n1[2] + 1))
    ok = launched and all(r <= 1.0 for _, r in checks.values())
    del out, want_out, grads, want_grads

    times = {
        "ms_fwd": gpu_ms(lambda: fa.gqa_fwd(q, k, v, causal), flush=flush),
        "ms_dq": gpu_ms(lambda: fa._launch_dq(q, k, v, do, want_lse, delta,
                                              causal, scale), flush=flush),
        "ms_dkv": gpu_ms(lambda: fa._launch_dkv(q, k, v, do, want_lse,
                                                delta, causal, scale),
                         flush=flush),
        "plain_ms_fwd": gpu_ms(lambda: fa._gqa_fwd_plain(q, k, v, causal),
                               flush=flush),
        "plain_ms_bwd": gpu_ms(lambda: fa._gqa_bwd_plain(
            q, k, v, do, want_lse, delta, causal), flush=flush),
        "library_ms_fwd": gpu_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), flush=flush)}
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                       enable_gqa=True)
    times["library_ms_bwd"] = gpu_ms(lambda: torch.autograd.grad(
        o, (qr, kr, vr), do, retain_graph=True), flush=flush)
    del o

    # the work these inputs need: each live (query, key) pair once; each
    # input read once and each output written once
    pairs = B * Hkv * G * (S * (S + 1) // 2 if causal else S * S)
    rate = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
    nq, nkv, rows = q.numel() * dt.itemsize, k.numel() * dt.itemsize, \
        B * Hkv * G * S * 4
    # The backward as one function, (q, k, v, dO, lse, delta) -> (dq, dk,
    # dv), needs 10·D per pair: the scores, dP, dV, dK and dQ products. The
    # dq and dkv kernels each recompute the scores and dP (6·D and 8·D);
    # their own bounds are kept beside it.
    bounds = {"fwd": _bound(2 * nq + 2 * nkv + rows, 4 * D * pairs, rate),
              "bwd": _bound(3 * nq + 4 * nkv + 2 * rows, 10 * D * pairs,
                            rate),
              "dq": _bound(3 * nq + 2 * nkv + 2 * rows, 6 * D * pairs, rate),
              "dkv": _bound(2 * nq + 4 * nkv + 2 * rows, 8 * D * pairs,
                            rate)}
    return {"case": name, "ok": ok, "launched_once_each": launched,
            "checks": {n: {"max_abs_err": e, "max_err_over_tol": r}
                       for n, (e, r) in checks.items()},
            "tol": tol, **times, "bounds": bounds,
            "shape": {"B": B, "Hq": Hkv * G, "Hkv": Hkv, "S": S, "D": D,
                      "dtype": dtype, "causal": causal}}


def _ce_case(N, V, seed, dev, flush):
    """The fused CE kernels through ``ce_fwd`` and ``ce_bwd`` (on the
    plain forward's lse) at the loss of the train phase: N = B*S rows,
    Llama-3's vocabulary, bf16 logits, int64 labels, the mean's gradient
    1/N; then times beside the plain versions and ``F.cross_entropy``."""
    import torch.nn.functional as F

    ce = importlib.import_module("paddle_tpu_torch.ops.fused_ce")
    sce = ce.softmax_cross_entropy
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((N, V), generator=g, device=dev) * 2).to(torch.bfloat16)
    lbl = torch.randint(0, V, (N,), generator=g, device=dev)
    gr = torch.full((N,), 1.0 / N, device=dev)
    n0 = (sce.launches_fwd, sce.launches_bwd)
    loss, lse = ce.ce_fwd(x, lbl)
    want_loss, want_lse = ce._ce_fwd_plain(x, lbl)
    dx = ce.ce_bwd(x, lbl, want_lse, gr)
    launched = (sce.launches_fwd, sce.launches_bwd) == (n0[0] + 1, n0[1] + 1)
    want_dx = ce._ce_bwd_plain(x, lbl, want_lse, gr)
    torch.cuda.synchronize()
    checks = {"loss": _check(loss, want_loss, *CE_TOL["loss"]),
              "lse": _check(lse, want_lse, *CE_TOL["loss"]),
              "dx": _check(dx, want_dx, *CE_TOL["dx"])}
    ok = launched and all(r <= 1.0 for _, r in checks.values())
    del dx, want_dx
    times = {
        "ms_fwd": gpu_ms(lambda: ce.ce_fwd(x, lbl), flush=flush),
        "ms_bwd": gpu_ms(lambda: ce.ce_bwd(x, lbl, want_lse, gr),
                         flush=flush),
        "plain_ms_fwd": gpu_ms(lambda: ce._ce_fwd_plain(x, lbl), flush=flush),
        "plain_ms_bwd": gpu_ms(lambda: ce._ce_bwd_plain(x, lbl, want_lse, gr),
                               flush=flush),
        "library_ms_fwd": gpu_ms(lambda: F.cross_entropy(
            x, lbl, reduction="none"), flush=flush)}
    xr = x.detach().requires_grad_()
    lib_loss = F.cross_entropy(xr, lbl, reduction="none")
    times["library_ms_bwd"] = gpu_ms(lambda: torch.autograd.grad(
        lib_loss, xr, gr, retain_graph=True), flush=flush)
    del lib_loss
    nx = N * V * 2
    # forward: logits and labels in, loss and lse out; backward: logits,
    # labels, lse and g in, dx out. Elementwise f32 work (max, exp, sum)
    # at the CUDA cores' rate.
    bounds = {"fwd": _bound(nx + 8 * N + 8 * N, 4 * N * V, F32_FLOP_PER_S),
              "bwd": _bound(2 * nx + 16 * N, 4 * N * V, F32_FLOP_PER_S)}
    return {"case": f"ce_N{N}_V{V}/bfloat16", "ok": ok,
            "launched_once_each": launched,
            "checks": {n: {"max_abs_err": e, "max_err_over_tol": r}
                       for n, (e, r) in checks.items()},
            "tol": CE_TOL, **times, "bounds": bounds,
            "shape": {"N": N, "V": V, "logits": "bfloat16",
                      "labels": "int64"}}


def phase_kernel(dev):
    Hkv, G, D, ps, W, P = 8, 4, 128, 64, 32, 8 * 32 + 1
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    dec_lens = [1, 2048, 777, 64, 0, 1500, 129, 1023]
    cases = []
    for kv in ("bfloat16", "int8"):
        cases.append(_kernel_case(f"decode/{kv}", 8, Hkv, G, D, ps, W, P,
                                  dec_lens, None, 1, kv, 1, dev, flush))
        for start in (0, 512):
            cases.append(_kernel_case(
                f"prefill_c256_start{start}/{kv}", 1, Hkv, G, D, ps, W, P,
                [start + 200], start, 256, kv, 2 + start, dev, flush))
    for c in cases:
        emit({"phase": "kernel", **c})
    gqa = [_gqa_case("gqa_B2_S4096_D128/bfloat16", 2, 8, 4, 4096, 128,
                     "bfloat16", True, 7, dev, flush),
           _gqa_case("gqa_B2_S256_D64/float32", 2, 2, 2, 256, 64,
                     "float32", True, 8, dev, flush)]
    ce = [_ce_case(8192, 128256, 5, dev, flush)]
    for c in gqa + ce:
        emit({"phase": "kernel", **c})
    bad = [c["case"] for c in cases + gqa + ce if not c["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"or did not launch once: {bad}")
    del flush
    torch.cuda.empty_cache()
    return {"paged": cases, "gqa": gqa, "ce": ce}


# --- phase 3: a small model, card against CPU ------------------------------

def _drive_small(dev, state, cfg):
    from paddle_tpu_torch.models.nlp import (LlamaForCausalLM,
                                             llama_paged_decode_factory,
                                             load_numpy_state_dict)

    model = load_numpy_state_dict(LlamaForCausalLM(cfg, device=dev), state)
    outer, layers, pools, prefill, step, dn = llama_paged_decode_factory(
        model, page_size=16, n_pool_pages=17, chunked_prefill=32,
        prefill_attention="kernel", emit="logits", device=dev)
    rng = np.random.default_rng(3)
    lens = np.asarray([50, 23], np.int32)
    toks = np.zeros((2, 64), np.int64)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(1, cfg.vocab_size, n)
    pt = torch.arange(1, 17, dtype=torch.int32).reshape(2, 8)
    logits, pools = prefill(outer, layers, torch.from_numpy(toks), pt,
                            torch.from_numpy(lens), pools)
    emits, _, _ = dn(outer, layers, logits.argmax(-1), pt,
                     torch.from_numpy(lens), pools, 6)
    return torch.cat([logits[None], emits]).cpu()


def _train_small(dev, state, cfg, tokens, labels):
    """The tiny train step on ``dev`` from ``state``: the gradients of the
    first step's loss, the losses of 3 steps and the parameters after them
    (each on the CPU)."""
    from paddle_tpu_torch.models.nlp import (LlamaForCausalLM,
                                             llama_train_step_factory,
                                             load_numpy_state_dict,
                                             param_views)
    from paddle_tpu_torch.models.nlp.llama_functional import loss_fn

    model = load_numpy_state_dict(LlamaForCausalLM(cfg, device=dev), state)
    params, opt, step = llama_train_step_factory(
        model, learning_rate=TRAIN_REF["lr"], remat=False, device=dev)
    tokens, labels = tokens.to(dev), labels.to(dev)
    outer, layers = param_views(params, cfg.num_hidden_layers)
    loss = loss_fn(cfg, outer, layers, tokens, labels, remat=False)
    grads = {k: g.cpu() for k, g in
             zip(params, torch.autograd.grad(loss, list(params.values())))}
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, tokens, labels)
        losses.append(float(loss))
    return losses, grads, {k: p.detach().cpu() for k, p in params.items()}


def phase_reference(dev):
    from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=4,
                           kv_heads=2)                  # head_dim 64
    state = {k: v.numpy() for k, v in
             LlamaForCausalLM(cfg, device="cpu", seed=11).state_dict()
             .items()}
    on_card = _drive_small(dev, state, cfg)
    on_cpu = _drive_small(torch.device("cpu"), state, cfg)
    diff = float((on_card - on_cpu).abs().max())
    same = bool(torch.equal(on_card.argmax(-1), on_cpu.argmax(-1)))
    out = {"phase": "reference", "max_logit_diff": diff,
           "tokens_identical": same, "atol": REF_ATOL}
    ok = same and diff <= REF_ATOL

    # the train step: B=2, S=256 (flash-eligible: the GQA kernels in f32)
    rng = np.random.default_rng(12)
    tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (2, 256)))
                      for _ in range(2))
    card = _train_small(dev, state, cfg, tokens, labels)
    cpu = _train_small(torch.device("cpu"), state, cfg, tokens, labels)
    loss_diff = max(abs(a - b) for a, b in zip(card[0], cpu[0]))
    grad_diff = max(float((card[1][k] - cpu[1][k]).abs().max())
                    for k in cpu[1])
    param_max, param_frac = 0.0, 0.0
    for k in cpu[2]:
        d = (card[2][k] - cpu[2][k]).abs()
        param_max = max(param_max, float(d.max()))
        param_frac = max(param_frac,
                         float((d > TRAIN_REF["param"]).float().mean()))
    train_ok = (loss_diff <= TRAIN_REF["loss"]
                and grad_diff <= TRAIN_REF["grad"]
                and param_frac <= TRAIN_REF["param_frac"]
                and param_max <= TRAIN_REF["lr"]
                and card[0][-1] < card[0][0])
    out.update({"train_losses_card": card[0], "train_losses_cpu": cpu[0],
                "train_loss_max_diff": loss_diff,
                "train_grad_max_diff": grad_diff,
                "train_param_max_diff": param_max,
                "train_param_frac_over_atol": param_frac,
                "train_tol": TRAIN_REF, "ok": ok and train_ok})
    emit(out)
    if not (ok and train_ok):
        raise AssertionError("the port on the card disagrees with the port "
                             "on the CPU")


# --- phase 4: serve Llama-3-8B ---------------------------------------------

def _requests(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [(f"req{i}", rng.integers(1, vocab, int(rng.integers(128, 1025)))
             .tolist(), int(rng.integers(32, 129))) for i in range(n)]


def phase_serve(dev, profile=False):
    from paddle_tpu_torch.examples.serve_paged_llama import serve
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_decode,
                                             llama_paged_decode_factory)
    from paddle_tpu_torch.ops import (PagedKVCache, paged_attention,
                                      paged_attention_reference)

    cfg = LlamaConfig.llama3_8b()
    L, Hkv = cfg.num_hidden_layers, cfg.num_key_value_heads
    hd = cfg.hidden_size // cfg.num_attention_heads
    ps, slots, slot_tokens, C = 64, 8, 2048, 256
    width = slot_tokens // ps
    n_pages = slots * width + 1                 # + the reserved page 0
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    outer, layers, pools, prefill, decode, _ = llama_paged_decode_factory(
        model, page_size=ps, n_pool_pages=n_pages, chunked_prefill=C,
        prefill_attention="kernel", emit="logits", device=dev)
    del model                  # the factory holds stacked copies
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    book = PagedKVCache(n_pages, ps, kv_heads=Hkv, head_dim=hd,
                        dtype=cfg.dtype, device=dev)
    reqs = _requests(0, 16, cfg.vocab_size)

    paged_attention.launches = 0
    t0 = time.perf_counter()
    res = serve(outer, layers, pools, prefill, decode, book, reqs,
                slots=slots, width=width, pad_to=C, log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches

    pools = res["pools"]
    chunks = sum(-(-len(p) // C) for _, p, _ in reqs)
    want_launches = L * (chunks + res["steps"])
    generated = sum(len(t) for t in res["done"].values())
    streams_ok = (len(res["done"]) == len(reqs)
                  and all(len(res["done"][s]) == n for s, _, n in reqs)
                  and all(0 <= t < cfg.vocab_size
                          for out in res["done"].values() for t in out))
    out = {"phase": "serve", "model": "llama3_8b", "layers": L,
           "dtype": "bfloat16", "requests": len(reqs),
           "served": len(res["done"]), "generated_tokens": generated,
           "decode_steps": res["steps"], "prefill_chunks": chunks,
           "tokens_per_s": generated / wall, "wall_s": wall,
           "setup_s": setup_s,
           "decode_step_ms_median": 1e3 * statistics.median(res["decode_s"]),
           "prefill_ms_median": 1e3 * statistics.median(res["prefill_s"]),
           "launches": launches, "launches_expected": want_launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}

    # one decode step, kernel vs plain attention, on identical pools
    sids = [f"cmp{i}" for i in range(slots)]
    rng = np.random.default_rng(1)
    lens = rng.integers(100, 1000, slots)
    for sid, n in zip(sids, lens):
        book.allocate(sid, slot_tokens)
        book.lengths[sid] = int(n)
    pt, ln = book.batch_views(sids)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (slots, 1024)))
    first, pools = prefill(outer, layers, toks.to(dev), pt, ln, pools)
    tok = first.argmax(-1)
    a = [t.clone() for t in pools]
    b = [t.clone() for t in pools]
    with_kernel, _ = decode(outer, layers, tok, pt, ln, tuple(a))
    llama_decode.paged_attention = paged_attention_reference
    try:
        with_plain, _ = decode(outer, layers, tok, pt, ln, tuple(b))
    finally:
        llama_decode.paged_attention = paged_attention
    torch.cuda.synchronize()
    diff = float((with_kernel - with_plain).abs().max())
    scale = float(with_plain.abs().max())
    out.update({"step_logit_max_diff": diff, "step_logit_atol": STEP_ATOL,
                "step_logit_max_abs": scale,
                "step_argmax_agree": float((with_kernel.argmax(-1)
                                            == with_plain.argmax(-1))
                                           .float().mean()),
                "step_logits_finite": bool(torch.isfinite(with_kernel)
                                           .all())})
    ok = (streams_ok and launches > 0 and launches == want_launches
          and out["step_logits_finite"] and diff <= STEP_ATOL)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("serve phase failed: " + json.dumps(out))
    if profile:
        emit({"phase": "profile", **_profile(
            lambda: decode(outer, layers, tok, pt, ln, pools),
            {"paged_attention": ("paged_attention",),
             "matmul": MATMUL_NAMES})})
    return out


MATMUL_NAMES = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitk")


def _profile(step, families, n=5):
    """Device time of a step by kernel family, from a ``torch.profiler``
    trace of ``n`` steps: each family of ``families`` ({name: substrings
    of the kernel name}) and everything else. The busy share is taken
    against the host-clock time of ``n`` steps run without the profiler,
    which slows the host."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) * 1e6 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    fam = {name: 0.0 for name in (*families, "other")}
    other = {}
    kernels = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels += 1
        name = e.name.lower()
        us = e.time_range.elapsed_us()
        f = next((f for f, words in families.items()
                  if any(w in name for w in words)), "other")
        fam[f] += us
        if f == "other":
            other[e.name[:80]] = other.get(e.name[:80], 0.0) + us
    if kernels == 0:
        raise RuntimeError("the profiler saw no device activity")
    busy_us = sum(fam.values()) / n
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": n, "step_ms": step_us / 1e3,
            "kernels_per_step": kernels / n,
            **{f"{k}_ms_per_step": v / n / 1e3 for k, v in fam.items()},
            "device_busy_ms_per_step": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / step_us,
            "other_top_ms_per_step": {k: v / n / 1e3 for k, v in top}}


# --- phase 5: train Llama-3-8B (8 layers) ------------------------------------

def _train_counts():
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention_gqa")
    ce = importlib.import_module("paddle_tpu_torch.ops.fused_ce")
    g, c = fa.grouped_flash_attention, ce.softmax_cross_entropy
    return {"gqa_fwd": g.launches_fwd, "gqa_dq": g.launches_dq,
            "gqa_dkv": g.launches_dkv, "ce_fwd": c.launches_fwd,
            "ce_bwd": c.launches_bwd}


def _zero_train_counts():
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention_gqa")
    ce = importlib.import_module("paddle_tpu_torch.ops.fused_ce")
    g, c = fa.grouped_flash_attention, ce.softmax_cross_entropy
    g.launches_fwd = g.launches_dq = g.launches_dkv = 0
    c.launches_fwd = c.launches_bwd = 0


def _step_flops(cfg, B, S):
    """6 x (matmul params incl. lm_head) x tokens + 12 x D x causal pairs
    x layers (attention: 4 forward, 8 backward; the backward kernels'
    recomputation of the scores is not counted)."""
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd = H // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * hd
    L = cfg.num_hidden_layers
    matmul_params = L * (2 * H * H + 2 * H * kv + 3 * H * F) + H * V
    pairs = B * cfg.num_attention_heads * S * (S + 1) // 2
    return 6 * matmul_params * B * S + 12 * hd * pairs * L, matmul_params


def _grads_with(swap, cfg, params, tokens, labels):
    """Loss and gradients of one forward+backward; ``swap`` runs the
    plain versions in place of the kernels (module attributes swapped, as
    the serve phase swaps ``paged_attention``)."""
    from paddle_tpu_torch.models.nlp import param_views
    from paddle_tpu_torch.models.nlp.llama_functional import loss_fn

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention_gqa")
    ce = importlib.import_module("paddle_tpu_torch.ops.fused_ce")
    kept = (fa.gqa_fwd, fa.gqa_bwd, ce.ce_fwd, ce.ce_bwd)
    if swap:
        fa.gqa_fwd, fa.gqa_bwd = fa._gqa_fwd_plain, fa._gqa_bwd_plain
        ce.ce_fwd, ce.ce_bwd = ce._ce_fwd_plain, ce._ce_bwd_plain
    try:
        outer, layers = param_views(params, cfg.num_hidden_layers)
        loss = loss_fn(cfg, outer, layers, tokens, labels, remat=False)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
    finally:
        fa.gqa_fwd, fa.gqa_bwd, ce.ce_fwd, ce.ce_bwd = kept
    return float(loss.detach()), grads


def phase_train(dev, profile=False):
    from paddle_tpu_torch.examples.train_llama_compiled import train
    from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=TRAIN_LAYERS)
    B, S, steps, lr, seed = 2, 4096, 5, 1e-3, 0

    # kernels against plain versions: one forward+backward each, identical
    # weights and batch (the batch train() makes from the same seed)
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    rng = np.random.default_rng(seed)
    tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (B, S))).to(dev)
                      for _ in range(2))
    loss_k, grads_k = _grads_with(False, cfg, params, tokens, labels)
    loss_p, grads_p = _grads_with(True, cfg, params, tokens, labels)
    rel = {}
    for k, a, b in zip(params, grads_k, grads_p):
        rel[k] = float((a.float() - b.float()).norm() / b.float().norm())
    del grads_k, grads_p
    # the forward and backward alone (no optimizer), warm, host clock
    t0 = time.perf_counter()
    _grads_with(False, cfg, params, tokens, labels)
    fwd_bwd_s = time.perf_counter() - t0
    del model, params
    torch.cuda.empty_cache()
    worst = max(rel, key=rel.get)

    # the main path: launch counts from 0, 5 steps
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    res = train(cfg, B, S, steps, lr=lr, device=dev, seed=seed, remat=False,
                log=None)
    torch.cuda.synchronize()
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"gqa_fwd": TRAIN_LAYERS * steps, "gqa_dq": TRAIN_LAYERS * steps,
            "gqa_dkv": TRAIN_LAYERS * steps, "ce_fwd": steps,
            "ce_bwd": steps}
    losses = res["losses"]
    step_s = statistics.median(res["step_s"])
    flops, matmul_params = _step_flops(cfg, B, S)
    out = {"phase": "train", "model": "llama3_8b",
           "layers": TRAIN_LAYERS, "layers_full": 32,
           "cut": "8 of 32 decoder layers, full width: params, grads and "
                  "f32 AdamW moments of 32 layers (~96 GB) exceed one 80 GB "
                  "card",
           "dtype": "bfloat16", "B": B, "S": S, "steps": steps, "lr": lr,
           "remat": False, "losses": losses,
           "step_ms_median": 1e3 * step_s,
           "step_ms": [1e3 * t for t in res["step_s"]],
           "fwd_bwd_ms": 1e3 * fwd_bwd_s,
           "tokens_per_s": B * S / step_s,
           "peak_mem_gb": peak_gb,
           "step_flops": flops, "matmul_params": matmul_params,
           "mfu": flops / step_s / BF16_FLOP_PER_S,
           "mfu_formula": "(6*matmul_params*tokens + 12*head_dim*pairs*"
                          "layers) / step_s / 989e12; pairs = B*heads*"
                          "S*(S+1)/2",
           "launches": counts, "launches_expected": want,
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_diff": abs(loss_k - loss_p),
           "loss_atol": TRAIN_LOSS_ATOL,
           "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
           "grad_rel_err_median": statistics.median(rel.values()),
           "grad_rel_limit": TRAIN_GRAD_REL,
           "grad_rel_err": rel}
    ok = (counts == want and all(np.isfinite(losses))
          and losses[-1] < losses[0]
          and out["loss_diff"] <= TRAIN_LOSS_ATOL
          and rel[worst] <= TRAIN_GRAD_REL)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("train phase failed: " + json.dumps(
            {k: v for k, v in out.items() if k != "grad_rel_err"}))
    if profile:
        step, params, opt = res["step"], res["params"], res["opt_state"]

        def one_step():
            float(step(params, opt, res["tokens"], res["labels"])[2])

        emit({"phase": "profile_train", **_profile(
            one_step, {"gqa_attention": ("gqa_",), "fused_ce": ("ce_fwd",
                                                                "ce_bwd"),
                       "matmul": MATMUL_NAMES}, n=3)})
    return out


# --- main -------------------------------------------------------------------

PHASES = ("build", "kernel", "reference", "serve", "train")


def _entry(name, source, replaces, launches, case, part, plain_part,
           err_keys, card, ms=None, bound=None):
    """One entry of the ``kernels`` line from a kernel-phase case."""
    b = bound or case["bounds"][part]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(case["checks"][k]["max_abs_err"]
                               for k in err_keys),
            "max_err_over_tol": max(case["checks"][k]["max_err_over_tol"]
                                    for k in err_keys),
            "ms": ms if ms is not None else case[f"ms_{part}"],
            "plain_ms": case[f"plain_ms_{plain_part}"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": case[f"library_ms_{plain_part}"],
            "check": "pass", "card": card, "case": case["case"]}


def _kernels_line(kern, serve, train, card):
    kernels = []
    cases = kern.get("paged", [])
    main_case = next((c for c in cases if c["case"] == "decode/bfloat16"),
                     None)
    if main_case is not None:
        kernels.append({
            "name": "paged_attention", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": serve.get("launches"),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": None,
            "check": "pass", "card": card,
            "cases": [{k: c[k] for k in ("case", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by")}
                      for c in cases]})
    launches = train.get("launches", {})
    if kern.get("gqa"):
        g = kern["gqa"][0]                  # the training shapes
        kernels.append(_entry(
            "gqa_flash_fwd", GQA_SOURCE, GQA_FWD_REPLACES,
            launches.get("gqa_fwd"), g, "fwd", "fwd", ("out", "lse"), card))
        b_dq, b_dkv = g["bounds"]["dq"], g["bounds"]["dkv"]
        kernels.append(_entry(
            "gqa_flash_bwd", GQA_SOURCE, GQA_BWD_REPLACES,
            (launches["gqa_dq"] + launches["gqa_dkv"]) if launches else None,
            g, None, "bwd", ("dq", "dk", "dv"), card,
            ms=g["ms_dq"] + g["ms_dkv"], bound=g["bounds"]["bwd"]))
        kernels[-1].update({"ms_dq": g["ms_dq"], "ms_dkv": g["ms_dkv"],
                            "bound_ms_dq": b_dq["bound_ms"],
                            "bound_ms_dkv": b_dkv["bound_ms"],
                            "launches_dq": launches.get("gqa_dq"),
                            "launches_dkv": launches.get("gqa_dkv")})
    if kern.get("ce"):
        c = kern["ce"][0]
        kernels.append(_entry("fused_ce_fwd", CE_SOURCE, CE_FWD_REPLACES,
                              launches.get("ce_fwd"), c, "fwd", "fwd",
                              ("loss", "lse"), card))
        kernels.append(_entry("fused_ce_bwd", CE_SOURCE, CE_BWD_REPLACES,
                              launches.get("ce_bwd"), c, "bwd", "bwd",
                              ("dx",), card))
    return kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also profile decode steps of the serve phase and "
                         "train steps of the train phase")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    kern, serve, train = {}, {}, {}
    if "build" in phases:
        phase_build()
    if "kernel" in phases:
        kern = phase_kernel(dev)
    if "reference" in phases:
        phase_reference(dev)
    if "serve" in phases:
        serve = phase_serve(dev, profile=args.profile)
        torch.cuda.empty_cache()
    if "train" in phases:
        train = phase_train(dev, profile=args.profile)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    emit({"kernels": _kernels_line(kern, serve, train, card)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
