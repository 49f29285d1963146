"""Mixture-of-Experts pretraining on one card: ``moe_train_step_factory``
over ``MoEForCausalLM`` (gating, scatter-add dispatch, the experts'
batched products, gather combine, the shared expert, the attention
kernels, the causal-LM CE plus the gates' aux loss, AdamW in place).

The one-device counterpart of ``examples/train_moe_ep.py``: the same
2-layer config with 16 fine-grained routed experts top-2 and one shared
expert, 8 steps of fresh (4, 65)-token batches at lr 5e-3. Sharding the
experts over an "expert" mesh axis (the all-to-all dispatch) waits for
ROADMAP item 15. ``--qwen2-57b`` trains Qwen2-57B-A14B's full widths
(64 routed experts top-8, one 20480-wide shared expert, V = 151,936) in
bf16 at the deepest cut of its 28 layers that fits the card
(``fitting_depth``; ``--layers`` sets another), B=1 × S=4096 on one
repeated batch, the chunked CE (chunks of 16384), and prints the peak
device memory beside the weights', gradients' and moments' bytes:

    python -m paddle_tpu_torch.examples.train_moe                # card
    python -m paddle_tpu_torch.examples.train_moe --qwen2-57b    # card
    python -m paddle_tpu_torch.examples.train_moe --qwen2-57b --layers 4
    python -m paddle_tpu_torch.examples.train_moe --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.models.nlp import (MoEConfig, MoEForCausalLM,
                                         moe_train_step_factory)

# examples/train_moe_ep.py's config: fine-grained routed experts and one
# always-on shared expert
EP_EXAMPLE = dict(vocab_size=512, hidden_size=64, intermediate_size=32,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=4, num_experts=16, top_k=2,
                  moe_every=1, num_shared_experts=1)
QWEN_CHUNK = 16384
# bytes a parameter: bf16 weight and gradient, f32 AdamW moments
STATE_BYTES = 2 + 2 + 4 + 4
# On one H100 80GB HBM3 at B=1 x S=4096 (bf16, no remat) the step's peak
# sat 2.95 GiB above the weights, gradients and moments at 3 layers and
# at 4 alike: AdamW's f32 temporaries of one slice
# (``train_utils.UPDATE_SLICE``) and the chunked CE set it, not the
# layers' activations
ABOVE_STATE = 3 * 2 ** 30
# the allocator's fragments at that peak: 4.45 GiB at 3 layers, 5.08 at 4
# (4 layers reserved 77.78 GiB of 78.66 free). The free memory before the
# step reads 77.9-78.66 GiB from run to run, so a margin of the fragments
# alone would take 4 layers in some runs and 3 in others; with 6 GiB an
# 80 GB card always takes 3
DEPTH_MARGIN = 6 * 2 ** 30


def param_count(cfg: MoEConfig, layers=None) -> int:
    """The parameters of ``cfg`` at ``layers`` decoder layers (all by
    default): the tied embedding, the final norm and each layer's norms,
    attention, router, routed experts and shared expert or dense MLP."""
    H, F, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    kv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
    L = cfg.num_hidden_layers if layers is None else layers
    attn = 2 * H * H + 2 * H * kv + 2 * H
    moe = H * E + 2 * E * H * F
    if cfg.num_shared_experts > 0:
        moe += 3 * H * cfg.shared_intermediate()
    n_moe = sum(1 for i in range(L) if i % cfg.moe_every == cfg.moe_every - 1)
    return (cfg.vocab_size * H + H + L * attn + n_moe * moe
            + (L - n_moe) * 3 * H * F)


def fitting_depth(cfg: MoEConfig, free_bytes: int) -> int:
    """The deepest cut of ``cfg`` whose bf16 weights and gradients and
    f32 moments, plus ``ABOVE_STATE`` and ``DEPTH_MARGIN``, fit
    ``free_bytes`` at B=1 x S=4096."""
    for layers in range(cfg.num_hidden_layers, 0, -1):
        need = (STATE_BYTES * param_count(cfg, layers) + ABOVE_STATE
                + DEPTH_MARGIN)
        if need <= free_bytes:
            return layers
    raise RuntimeError(f"one layer of {cfg} does not fit "
                       f"{free_bytes / 2 ** 30:.1f} GiB")


def train(cfg, B, S, steps, lr=1e-4, device=None, seed=0,
          dtype=torch.float32, chunked_vocab_ce=None, warmup=0, fresh_batches=False, log=print):
    """``warmup`` then ``steps`` steps of ``moe_train_step_factory`` on a
    model made from ``seed`` in ``dtype``: on one batch of (B, S + 1)
    random tokens from ``numpy`` seeded with ``seed`` (tokens [:, :-1],
    labels [:, 1:]), or with ``fresh_batches`` a new one each step.

    Returns {"losses", "step_s", "warmup_losses", "model", "params",
    "opt_state", "step", "tokens", "labels"}; ``step_s`` is the host
    clock of each step after the warm-up up to its loss on the host."""
    dev = resolve_device(device)
    model = MoEForCausalLM(cfg, device=dev, seed=seed).to(dtype)
    params, opt_state, step = moe_train_step_factory(
        model, learning_rate=lr, chunked_vocab_ce=chunked_vocab_ce,
        device=dev)
    rng = np.random.default_rng(seed)

    def batch():
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
        return tok[:, :-1].to(dev), tok[:, 1:].to(dev)

    tokens, labels = batch()
    warm, losses, step_s = [], [], []
    for i in range(warmup + steps):
        if fresh_batches and i:
            tokens, labels = batch()
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=None,
                    help="default 8 (5 with --qwen2-57b)")
    ap.add_argument("--qwen2-57b", action="store_true",
                    help="Qwen2-57B-A14B's widths, bf16, the deepest cut "
                         "that fits the card")
    ap.add_argument("--layers", type=int, default=None,
                    help="with --qwen2-57b: this many of its 28 layers")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("expert parallelism (an 'expert' mesh axis, the all-to-all "
          "dispatch) waits for ROADMAP item 15: one device")
    if args.qwen2_57b:
        if dev.type != "cuda":
            raise SystemExit("--qwen2-57b needs the card")
        full = MoEConfig.qwen2_57b_a14b()
        free, _ = torch.cuda.mem_get_info(dev)
        layers = args.layers or fitting_depth(full, free)
        n = param_count(full, layers)
        print(f"{layers} of {full.num_hidden_layers} layers "
              f"({n / 1e9:.2f} B parameters)")
        cfg = dataclasses.replace(full, num_hidden_layers=layers)
        torch.cuda.reset_peak_memory_stats(dev)
        losses = train(cfg, 1, 4096, args.steps or 5, lr=1e-4, device=dev,
                       dtype=torch.bfloat16,
                       chunked_vocab_ce=QWEN_CHUNK)["losses"]
        gib = 2 ** 30
        print(f"free before {free / gib:.2f} GiB; weights, gradients and "
              f"moments {STATE_BYTES * n / gib:.2f} GiB; peak allocated "
              f"{torch.cuda.max_memory_allocated(dev) / gib:.2f} GiB, "
              f"reserved {torch.cuda.max_memory_reserved(dev) / gib:.2f} GiB")
        return losses
    return train(MoEConfig(**EP_EXAMPLE), 4, 64, args.steps or 8, lr=5e-3,
                 device=dev, fresh_batches=True)["losses"]


if __name__ == "__main__":
    main()
