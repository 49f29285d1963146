#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card: the quickest proof that the port still builds, is right and serves.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases build,kernel

Phases, each printing one JSON line:

1. ``build``: compile every kernel under ``paddle_tpu_torch/ops/kernels``
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel).
2. ``kernel``: the port's wrappers ``paged_attention`` (decode) and
   ``paged_prefill_attention`` (a chunk), which launch the paged-attention
   kernel, against the plain version ``paged_attention_reference`` at the
   serving shapes of Llama-3-8B (32 query / 8 kv heads, head_dim 128,
   page 64): decode at B=8 with ragged lengths 1..2048 and one pad row of
   length 0, and a 256-token prefill chunk at starts 0 and 512; q in
   bf16, pools in bf16 and in int8 with per-slot scales, within
   ``KERNEL_ATOL + KERNEL_RTOL * |plain|``. Both are timed with CUDA events (median of ``REPS``, L2 flushed before each
   call) beside the bound: the least time the card could take, from the
   bytes that must move at 3.35 TB/s and the operations at 989 TFLOP/s.
3. ``reference``: a small f32 Llama through the port on the card (the
   kernel) and on the CPU (the plain version): greedy tokens identical,
   logits within ``REF_ATOL``.
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

Then the card's name and power limit, the ``kernels`` line, and, last,
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result line. Without CUDA it exits at once.
"""
from __future__ import annotations

import argparse
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

SOURCE = "paddle_tpu_torch/ops/kernels/paged_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:46"


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
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"paged attention kernel disagrees with its "
                             f"plain version: {bad}")
    return cases


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
    emit({"phase": "reference", "ok": same and diff <= REF_ATOL,
          "max_logit_diff": diff, "tokens_identical": same,
          "atol": REF_ATOL})
    if not (same and diff <= REF_ATOL):
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
        emit({"phase": "profile", **_profile_decode(
            lambda: decode(outer, layers, tok, pt, ln, pools))})
    return out


def _profile_decode(step, n=5):
    """Device time of a decode step by kernel family, from a
    ``torch.profiler`` trace of ``n`` steps: the paged-attention kernel,
    matrix products, and everything else. The busy share is taken against
    the host-clock time of ``n`` steps run without the profiler, which
    slows the host."""
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
    fam = {"paged_attention": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels += 1
        name = e.name.lower()
        us = e.time_range.elapsed_us()
        if "paged_attention" in name:
            fam["paged_attention"] += us
        elif any(w in name for w in ("gemm", "gemv", "nvjet", "cutlass",
                                     "xmma", "splitk")):
            fam["matmul"] += us
        else:
            fam["other"] += us
    if kernels == 0:
        raise RuntimeError("the profiler saw no device activity")
    busy_us = sum(fam.values()) / n
    return {"steps": n, "step_ms": step_us / 1e3,
            "kernels_per_step": kernels / n,
            **{f"{k}_ms_per_step": v / n / 1e3 for k, v in fam.items()},
            "device_busy_ms_per_step": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / step_us}


# --- main -------------------------------------------------------------------

PHASES = ("build", "kernel", "reference", "serve")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also profile decode steps of the serve phase")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    cases, serve = [], {}
    if "build" in phases:
        phase_build()
    if "kernel" in phases:
        cases = phase_kernel(dev)
    if "reference" in phases:
        phase_reference(dev)
    if "serve" in phases:
        serve = phase_serve(dev, profile=args.profile)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    main_case = next((c for c in cases if c["case"] == "decode/bfloat16"),
                     None)
    kernels = []
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
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
