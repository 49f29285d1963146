"""The flagship training path of the PyTorch port: Llama training steps
through ``llama_train_step_factory`` — the forward with the attention
kernels (grouped or multi-head flash; splash for a ``sliding_window``
shorter than the sequence), the fused CE loss, the backward (their
backward kernels) and AdamW, updated in place.

Counterpart of ``examples/train_llama_compiled.py``. ``train`` is the loop;
``main`` runs it:

    # on the card: Llama-3-8B at full width, 8 of its 32 layers, B=2, S=4096
    python -m paddle_tpu_torch.examples.train_llama_compiled
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
          log=print):
    """``steps`` training steps of a model made from ``seed`` on one fixed
    random batch (tokens and labels from ``numpy`` seeded with ``seed``).

    Returns {"losses": [...], "step_s": [...], "model", "params",
    "opt_state", "step", "tokens", "labels"}; ``step_s`` is the host clock
    of each step up to its loss on the host (which waits for the card)."""
    dev = resolve_device(device)
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    params, opt_state, step = llama_train_step_factory(
        model, learning_rate=lr, remat=remat, device=dev)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    losses, step_s = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens, labels)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        if log:
            log(f"step {i}: loss {losses[-1]:.4f} "
                f"({1e3 * step_s[-1]:.1f} ms)")
    return {"losses": losses, "step_s": step_s, "model": model,
            "params": params, "opt_state": opt_state, "step": step,
            "tokens": tokens, "labels": labels}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the tiny config)")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        cfg = LlamaConfig.tiny(vocab=512, hidden=256, layers=2, heads=4,
                               kv_heads=2)
        B, S = 2, 256
    else:
        # 8 layers: params, grads and f32 AdamW moments of all 32 exceed
        # one 80 GB card
        cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                                  num_hidden_layers=8)
        B, S = 2, 4096
    train(cfg, B, S, args.steps, device=dev)


if __name__ == "__main__":
    main()
