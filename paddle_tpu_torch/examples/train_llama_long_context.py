"""Long-context Llama training on one card: the (B·S, V) logits are never
built, and the layers keep only their projections' outputs.

Counterpart of ``examples/train_llama_long_context.py``: the same three
steps with tied embeddings, ``remat="dots"`` (the projections' products
are saved, the rest, attention included, is recomputed in the backward)
and ``chunked_vocab_ce`` (the tied head and the CE run vocabulary chunk by
chunk), here also with fused qkv and gate/up weights. The steps train on
one repeated batch, so the loss falls.

    # on the card: Llama-3.2-3B's widths, all 28 layers, B=1, S=8192
    python -m paddle_tpu_torch.examples.train_llama_long_context
    # on the CPU: the reference example's shrunk shape (tiny, vocab 211,
    # S=256, chunks of 48)
    python -m paddle_tpu_torch.examples.train_llama_long_context --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.examples.train_llama_compiled import train
from paddle_tpu_torch.models.nlp import LlamaConfig


def llama32_3b_long():
    """Llama-3.2-3B's widths (its published config.json): hidden 3072,
    FFN 8192, 28 layers, 24 heads over 8 kv heads (head_dim 128, G = 3),
    vocab 128256, rope theta 500000, tied embeddings; here with fused qkv
    and gate/up weights. Its "llama3" rope scaling is not in
    ``LlamaConfig`` (nor the reference's): plain rope."""
    return LlamaConfig(vocab_size=128256, hidden_size=3072,
                       intermediate_size=8192, num_hidden_layers=28,
                       num_attention_heads=24, num_key_value_heads=8,
                       max_position_embeddings=131072,
                       rope_theta=500000.0, tie_word_embeddings=True,
                       fuse_attention_qkv=True, fuse_ffn_gate_up=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the tiny config)")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        # the reference example's shrunk shape
        cfg = dataclasses.replace(
            LlamaConfig.tiny(vocab=211, hidden=64, layers=2, heads=4,
                             kv_heads=2),
            max_position_embeddings=256, tie_word_embeddings=True,
            fuse_attention_qkv=True, fuse_ffn_gate_up=True)
        B, S, chunk = 1, 256, 48
    else:
        # 8 vocabulary chunks, the last padded
        cfg, B, S, chunk = llama32_3b_long(), 1, 8192, 16384
    res = train(cfg, B, S, args.steps, lr=3e-4, device=dev, remat="dots",
                chunked_vocab_ce=chunk)
    print(f"long-context train OK at S={S} (vocab chunks of {chunk})")
    return res["losses"]


if __name__ == "__main__":
    main()
