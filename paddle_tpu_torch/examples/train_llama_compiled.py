"""The flagship training path of the PyTorch port: Llama training steps
through ``llama_train_step_factory`` — the forward with the attention
kernels (grouped or multi-head flash; splash for a ``sliding_window``
shorter than the sequence), the fused CE loss, the backward (their
backward kernels) and AdamW, updated in place.

Counterpart of ``examples/train_llama_compiled.py``, with its options:
``remat`` (False | True | "dots") for memory and ``offload_moments``
(AdamW's moments in pinned host memory) for a model whose moments do not
fit the card. ``train`` is the loop; ``main`` runs it:

    # on the card: Llama-3-8B at full width, 8 of its 32 layers, B=2, S=4096
    python -m paddle_tpu_torch.examples.train_llama_compiled
    # all 32 layers: moments in pinned host memory (64 GiB of it), remat
    python -m paddle_tpu_torch.examples.train_llama_compiled --full-depth
    # on the CPU: a tiny GQA config (plain versions of the kernels)
    python -m paddle_tpu_torch.examples.train_llama_compiled --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                         llama_train_step_factory)


def train(cfg, B, S, steps, lr=1e-3, device=None, seed=0, remat=False,
          log=print, offload_moments=False, chunked_vocab_ce=None,
          warmup=0):
    """``warmup`` then ``steps`` training steps of a model made from
    ``seed`` on one fixed random batch (tokens and labels from ``numpy``
    seeded with ``seed``), through ``llama_train_step_factory`` with
    ``remat``, ``offload_moments`` and ``chunked_vocab_ce``.

    Returns {"losses": [...], "step_s": [...], "warmup_losses": [...],
    "model", "params", "opt_state", "step", "tokens", "labels"}; the
    losses and ``step_s`` are those of the ``steps`` after the warm-up,
    ``step_s`` the host clock of each step up to its loss on the host
    (which waits for the card)."""
    dev = resolve_device(device)
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    params, opt_state, step = llama_train_step_factory(
        model, learning_rate=lr, remat=remat, device=dev,
        offload_moments=offload_moments, chunked_vocab_ce=chunked_vocab_ce)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    warm, losses, step_s = [], [], []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens, labels)
        value, dt = float(loss), time.perf_counter() - t0
        if i < warmup:
            warm.append(value)
        else:
            losses.append(value)
            step_s.append(dt)
        if log:
            log(f"step {i}: loss {value:.4f} ({1e3 * dt:.1f} ms)")
    return {"losses": losses, "step_s": step_s, "warmup_losses": warm,
            "model": model, "params": params, "opt_state": opt_state,
            "step": step, "tokens": tokens, "labels": labels}


def _remat(value):
    return {"false": False, "true": True, "dots": "dots"}[value.lower()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the tiny config)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--remat", type=_remat, default=None,
                    help="False | True | dots (default False; True with "
                         "--full-depth)")
    ap.add_argument("--offload-moments", action="store_true",
                    help="AdamW moments in pinned host memory")
    ap.add_argument("--full-depth", action="store_true",
                    help="on the card: all 32 layers, with offloaded "
                         "moments and remat=True")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    remat, offload = args.remat, args.offload_moments
    if dev.type == "cpu":
        cfg = LlamaConfig.tiny(vocab=512, hidden=256, layers=2, heads=4,
                               kv_heads=2)
        B, S = 2, 256
    elif args.full_depth:
        # params and grads (bf16) take 32.1 GB of the card; the f32
        # moments (64.2 GB) live in pinned host memory
        cfg = LlamaConfig.llama3_8b()
        B, S = 2, 4096
        offload = True
        remat = True if remat is None else remat
    else:
        # 8 layers: params, grads and f32 AdamW moments of all 32 exceed
        # one 80 GB card (--full-depth moves the moments to the host)
        cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                                  num_hidden_layers=8)
        B, S = 2, 4096
    return train(cfg, B, S, args.steps, device=dev,
                 remat=False if remat is None else remat,
                 offload_moments=offload)["losses"]


if __name__ == "__main__":
    main()
