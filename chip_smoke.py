#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card: the quickest proof that the port still builds, is right, serves and
trains.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases build,kernel
    python3 chip_smoke.py --phases build,kernel,train
    python3 chip_smoke.py --phases build,kernel,train_mha,train_window
    python3 chip_smoke.py --phases build,kernel,train_encoder
    python3 chip_smoke.py --phases build,reference,train_bert
    python3 chip_smoke.py --phases build,reference,train_resnet50
    python3 chip_smoke.py --phases build,reference,train_full,train_long
    python3 chip_smoke.py --phases build,train,train_mha,train_window \
        --plain-curves

Phases, each printing JSON lines:

1. ``build``: compile every kernel under ``paddle_tpu_torch/ops/kernels``
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel);
   then count the HGMMA (wgmma) instructions of each 16-bit attention
   kernel (forward, dq and dk/dv at head_dim 64, 128 and 256, bfloat16
   and float16, both libraries) and of each paged prefill instance
   (``paged_prefill_mma`` over bf16 and int8 pools at head_dim 64, 128
   and 256) in their SASS (``cuobjdump``): one that is missing or has
   none fails.
2. ``kernel``: each kernel through its wrapper at the shapes of the main
   paths, against its plain version on the same inputs, element by
   element within the stated tolerance; each call must launch its kernel
   once, and the paged calls and the attention backward kernels (dq,
   dk/dv) launched twice on the same inputs must give the same bits. Times are CUDA events (median
   of ``REPS``, L2 flushed before each call) beside the bound (the least
   time the card could take: the bytes that must move at 3.35 TB/s, the
   operations at the data sheet's peak for their type) and, where one
   PyTorch call computes the same function, that call's time (a
   yardstick, never on the port's path).
   * paged attention (``paged_attention``, ``paged_prefill_attention``)
     at the serving shapes of Llama-3-8B (32 query / 8 kv heads, head_dim
     128, page 64): decode at B=8 with ragged lengths 1..2048 and one pad
     row of length 0, and a 256-token prefill chunk at starts 0 and 512;
     q in bf16, pools in bf16 and in int8 with per-slot scales; decode of
     one 16,384-token sequence, at B=32 with ragged lengths up to 2048, at
     G = 1 over 32 kv heads (Llama-2-7B's) and at G = 8; the 256-token
     chunk at start 512 at G = 1 over 32 kv heads, at G = 8, at head_dim
     64 and 256, over pages of 16, for four sequences of ragged lengths,
     and in float32. Each case records the instance that the kernel's
     entry reports it launched (``split``: decode split over pages, with
     its ``n_split``; ``mma``: a bf16 chunk on the tensor cores; ``rows``:
     one block per row tile), which must be the one its shapes call for
     (a bf16 chunk ``mma``, float32 ``rows``), and whether a second launch
     gives the same bits;
   * grouped flash attention (``gqa_fwd``; ``gqa_bwd``: the dq and dkv
     kernels) at the training shapes of Llama-3-8B: B=2, 32 query / 8 kv
     heads, S=4096, head_dim 128, bf16, causal; and at head_dim 64, f32,
     S=256 (the reference phase's shapes);
   * multi-head flash attention (``mha_fwd``, ``mha_bwd``: the same
     kernels at G = 1, counted on ``flash_attention``) at the training
     shapes of Llama-2-7B (B=2, 32 heads, S=4096, head_dim 128, bf16,
     causal), at f32 head_dim 64 S=256, and at Sq=1024 != Sk=2048;
   * splash attention (``splash_fwd``, ``splash_bwd``) at the training
     shapes of Mistral-7B (B=1, 32 query / 8 kv heads, S=8192, head_dim
     128, bf16, the band of window 4096 as the model builds it), then G = 1
     banded, a random mask with an empty block row (out exactly 0, lse
     exactly NEG_INF), a shifted query frame, mask blocks of 16 (smaller
     than the kernels' tiles) and f32;
     the yardstick of the three attention kinds is
     ``F.scaled_dot_product_attention`` (causal, or the live pairs as a
     boolean mask; K/V repeated where a backend refuses ``enable_gqa``)
     forward, and its backward alone, with the backend that ran it;
   * grouped flash attention once more at the train_long phase's call:
     B=1, 24 query / 8 kv heads (G = 3), S=8192, head_dim 128, bf16,
     causal;
   * fused cross-entropy (``ce_fwd``, ``ce_bwd``) at N=8192 rows of
     V=128256 bf16 logits, int64 labels. Yardstick: ``F.cross_entropy(...,
     reduction="none")`` forward, and its backward alone.
   * multi-head flash once more at the train_encoder phase's call: B=32,
     12 heads, S=512, head_dim 64, bf16, non-causal;
   * the norm kernels of ``layer_norm.cu`` through ``fused_layer_norm``,
     ``fused_rms_norm`` (rows 12-13: entry points no model path calls) and
     ``fused_dropout_add_layer_norm`` (row 14): LayerNorm and RMSNorm at
     Llama-3-8B's width (8192 x 4096 bf16), the encoder's (16384 x 768)
     in bf16 and f32, odd and long rows, eps 1e-12; dropout-add-LN at the
     encoder's call (16384 x 768 bf16, p = 0.1) in training and eval, f32,
     p = 0.5, ragged N, odd H, with dropout bits at the edges of the keep
     decision and the keep mask checked exactly. Yardsticks:
     ``F.layer_norm``, ``F.rms_norm`` (where this PyTorch has it, with the
     kernels one call launches); none for dropout-add-LN. Then row 12
     once more against ``F.layer_norm`` at 8192 x 4096 and 16384 x 768
     bf16, ``REPS`` calls of each in turns: medians, quartiles and
     extremes, and whether either is slower beyond the noise (its first
     quartile above the other's third).
   Bounds count the live (query, key) pairs of each call's data. This
   phase runs before any model is on the card: the plain attention at
   S=4096 holds 4.3 GB score tensors.
3. ``reference``: a small f32 Llama (hidden 256, 4 / 2 heads, head_dim 64,
   2 layers) through the port on the card (the kernels) and on the CPU
   (the plain versions), from the same weights: greedy decode tokens
   identical and logits within ``REF_ATOL``; then the train step at B=2,
   S=256: the losses of 3 steps, every gradient of step 1 and every
   parameter after step 3; the same for a second one at head_dim 256
   with a kv group of 3 (hidden 768, 3 / 1 heads); then a small f32
   post-LN encoder (2
   ``FusedTransformerEncoderLayer``s, d=128, 2 heads, B=2, S=256: the
   flash and dropout-add-LN kernels) the same way at dropout 0: its
   output, then 3 AdamW steps; and a small f32 ``BertForPretraining``
   (``BERT_SMALL``: hidden 128, 2 heads, 2 layers, B=2, S=256: the
   multi-head flash kernels) at dropout 0: its MLM and NSP logits without
   and with an attention mask (the dense path), then 3 steps of
   ``bert_pretrain_step_factory``. The training step's options, on a
   small f32 tied Llama with fused qkv and gate/up weights: logits with
   explicit (B, S) positions, then 3 steps with ``remat="dots"``, the
   chunked CE (chunks of 48 over 256: the last padded) and offloaded
   moments (pinned on the card), card against CPU by the same rules. Then the vision slice, which runs no
   TPU kernel's counterpart, with TF32 off: a small f32 ResNet-18 (10
   classes, B=8, 64 x 64) and LeNet (B=16 synthetic digits): train-mode
   logits, loss and running statistics, then 3 steps of
   ``resnet_train_step_factory`` (losses, step 1's gradients, parameters,
   velocities and buffers); and the max-pool tie case (a 6 x 6 map of
   zeros after a ReLU, kernel 3, stride 2, pad 1), whose gradient must land
   where the CPU's does.
4. ``serve``: Llama-3-8B at full width and depth, bf16, random weights
   from a seed, through ``examples/serve_paged_llama.serve``: 16 requests,
   continuous batching in 8 slots of 2048 tokens, chunked prefill of 256
   tokens through the kernel, fixed-shape decode steps with pad rows on
   the reserved page 0. The kernel's launch counts, in all and by the
   instance its entry reports, are set to 0 just before and read just
   after, and must equal the launches the run implies: a decode step's
   layers the split instance, a prefill chunk's the tensor cores'. Then
   one decode step runs with the kernel and with the plain version on
   identical pools, and their logits are compared. With ``--profile``, a
   ``torch.profiler`` trace of decode steps splits the step's device time
   into the attention kernel's three instances, matrix products and the
   rest, and one of a
   1024-token request's prefill (4 chunks; ``profile_prefill``) does the
   same for the time to the first token.
5. ``train``, ``train_mha``, ``train_window``: Llama-3-8B (GQA, B=2,
   S=4096), Llama-2-7B (multi-head, ``LlamaConfig()``, B=2, S=4096) and
   Mistral-7B-v0.1 (GQA with a sliding window of 4096, B=1, S=8192), each
   at full width with 8 of its 32 layers (the cut that lets params, grads
   and AdamW moments fit one 80 GB card), bf16, random weights from a
   seed, through
   ``examples/train_llama_compiled.train``: 5 AdamW steps (lr 1e-3) on one
   fixed batch. First, one forward and backward with the kernels and one
   with their plain versions on identical weights: the loss difference
   and each parameter's relative gradient error; one more with the
   kernels is timed alone (``fwd_bwd_ms``: a step less its AdamW update,
   on the host clock). Then the launch counts
   are set to 0, the 5 steps run, and the counts must be 8 forward, 8 dq
   and 8 dkv launches per step of the phase's own attention kernels
   (grouped flash, multi-head flash, splash), none of the other two, and
   1 + 1 CE launches per step; every loss must be finite and the last
   below the first. With ``--profile``, a ``torch.profiler`` trace splits
   a train step into the flash and splash kernels, the CE kernels, matrix
   products and the rest, with the rest's costliest kernels by name.
   With ``--plain-curves``, the 5 steps run once more from the same
   weights and batch with the plain attention and CE versions, and both
   loss curves are printed (``plain_curves_<phase>``).

8. ``train_full`` and 9. ``train_long``: Llama-3-8B at all 32 layers (the host's memory
   permitting: else the deepest cut whose moments it can pin, printed as
   ``cut``), bf16, B=2, S=4096, ``remat=True`` and ``offload_moments``:
   AdamW's f32 moments (64.2 GB) in pinned host memory, streamed through
   the card in chunks of 4 tensors. ``train_long``: Llama-3.2-3B's widths
   (the long-context example's config: tied, fused qkv and gate/up,
   plain rope) at all 28 layers, bf16, B=1, S=8192, ``remat="dots"`` and
   the chunked CE (chunks of 16384). Each first checks, at full width and
   2 layers: the kernels against their plain versions (one
   forward+backward each: |Δloss| and every parameter's relative gradient
   error); that ``remat`` False, True and ``"dots"`` give the same bits;
   ``train_long`` the chunked CE against the dense f32 one on its final
   hidden states and embedding (loss, dx, dw); ``train_full`` 3 steps with
   offloaded moments against 3 with moments on the card (the same bits,
   every moment pinned). Then the launch counts are set to 0, a warm-up
   step and 5 steps run through ``examples/train_llama_compiled.train``
   (AdamW lr 1e-3 and 3e-4, one repeated batch), and the counts must be
   exactly the path's: per step 2 x layers grouped flash forward (each
   layer's forward runs again in the backward), layers dq and layers dk/dv,
   1 + 1 fused CE for ``train_full`` and none for ``train_long``, no other
   kernel. A forward and backward alone (``fwd_bwd_ms``) and one more
   whole step are timed (``update_ms``: the step less the forward and
   backward), and the moments' copies alone, each direction on its
   own (``pcie``). Records step ms, tokens/s, MFU, peak device memory,
   the moments' bytes and where they live, the host's memory, and the
   losses (finite, the last below the first).

10. ``train_encoder``: 12 post-LN ``FusedTransformerEncoderLayer``s of
   ``incubate.nn`` at BERT-base's widths (768, 12 heads, FFN 3072, GELU,
   dropout 0.1), bf16, random weights from a seed, on hidden states
   (B=32, S=512) against an N(0, 1) target (MSE), trained 5 steps on one
   batch with ``adamw_update`` (f32 moments, lr 1e-4) in training mode.
   First one forward and backward with the kernels and one with their
   plain versions, on identical weights and dropout draws; then the
   launch counts are set to 0, the 5 steps run, and the counts must be
   24 dropout-add-LN and 12 + 12 + 12 multi-head flash launches per step
   and none of any other kernel.

11. ``train_bert``: ``BertForPretraining`` at BERT-base (``BertConfig()``:
   vocab 30522, hidden 768, 12 layers, 12 heads, FFN 3072, GELU, dropout
   0.1), bf16, random weights from a seed, full depth, in training mode
   (dropout live, drawn from one generator), on seeded data (B=32, S=512:
   ids uniform over the vocabulary, token types 0 then 1, MLM labels on
   15 % of the positions, NSP labels), through
   ``bert_pretrain_step_factory`` (its AdamW defaults, no remat, no
   mesh). First one forward and backward of the pretraining loss with the
   multi-head flash kernels and one with their plain versions, on
   identical weights, batch and dropout draws; one warm-up step; then the
   launch counts are set to 0, 5 steps run, and the counts must be 12 +
   12 + 12 multi-head flash launches per step and none of any other
   kernel; the losses finite and falling. Records step ms, tokens/s,
   MFU, ``fwd_bwd_ms`` and peak memory; with ``--profile``
   (``profile_train_bert``) the step's device time by family (flash,
   log-softmax, matrix products, the rest), idle share and kernels a
   step.

12. ``train_resnet50``: ``resnet50()`` (1000 classes, full depth and
    width), bf16 parameters with f32 masters, f32 batch-norm buffers, on
    B=256 seeded class-template images of 3 x 224 x 224 (NCHW; one
    repeated batch), through ``resnet_train_step_factory`` (its defaults:
    momentum SGD, lr 0.1, momentum 0.9, L2 decay 1e-4 on every parameter;
    BASELINE.md config 2's recipe). One forward and backward is timed
    alone (``fwd_bwd_ms``); one warm-up step; then the launch counts are
    set to 0, 5 steps run, and every count must stay 0 (no TPU kernel's
    counterpart lies on this path: the convolutions are cuDNN's, the
    batch norms and pools the reference's formulas). Records images/s,
    step ms, MFU (the step's FLOPs counted from the model's own
    convolution and fc shapes: 2 x multiply-adds forward, x 3 for the
    step), peak memory and the losses (finite, the last below the first);
    with ``--profile`` (``profile_train_resnet50``) the step's device time
    by family (pooling, layout transforms, convolutions, matrix products,
    elementwise and reduction kernels, the rest), idle share and kernels
    a step.

Then the card's name and power limit, the ``kernels`` line, and, last,
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result line. Without CUDA it exits at once.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
# the same with an f32 output: the order of the f32 sums only
PAGED_TOL = {"bfloat16": (KERNEL_ATOL, KERNEL_RTOL),
             "float32": (1e-5, 1e-5)}
# f32 model, card (kernel, cuBLAS in full f32) vs CPU (plain, MKL):
# summation order only
REF_ATOL = 1e-4
# 8B decode step, kernel vs plain attention on identical pools: one bf16
# rounding apart per layer, carried through 32 bf16 layers. Reading
# 0.238 (max |logit| 6.19); the limit is about twice it.
STEP_ATOL = 0.5

# attention kernels (grouped and multi-head flash, splash), kernel vs
# plain on the same inputs. bf16: the same roundings (q2, probabilities,
# ds) on f32 sums in another order, and the forward's online softmax
# rounds each probability against the running max rather than the final
# one: an element may land a bf16 ulp or two apart. Readings at the
# training shapes, err/limit: GQA (S=4096) 0.64 out, 0.51 dq, 0.46 dk/dv;
# multi-head (S=4096) 0.60, 0.47, 0.80 / 0.45; splash at the Mistral band
# (S=8192) 0.52, 0.35, 0.46 / 0.45; at most 0.77 in the other cases. f32:
# order of the sums only (readings at most 0.03 of the limit).
# float16: the same roundings to f16, whose ulp is 2^-10 relative (2^-7
# for bf16): out within two f16 ulps, 2^-9 of |plain| on an atol of 2e-4
# (readings 0.35-0.77 of it). A gradient sums a key's or a query's
# products of round(ds), whose f16 roundings flip apart where the f32
# sums differ in order: its error does not shrink with its magnitude
# (readings against the output's limit: up to 1.64, an abs err of 4.9e-4
# at |plain| near 0.05, and 7.3e-4 in the card tests), so its limit is
# about twice the readings: 1.5e-3 + 2^-8·|plain| (one H100; PERF.md §2).
GQA_TOL = {"bfloat16": dict(out=(2e-3, 2 ** -6), grad=(2e-3, 2 ** -6)),
           "float16": dict(out=(2e-4, 2 ** -9), grad=(1.5e-3, 2 ** -8)),
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
# twice the readings. The same for the other two models: Llama-2-7B loss
# 5.55e-4 apart (of 11.17; 5.0e-5 relative), gradients 0.031 median,
# 0.054 worst; Mistral-7B loss 1.55e-4 (of 11.22), gradients 0.031,
# 0.055. That these gaps are bf16 noise and no fault: on small bf16 models
# the kernels' losses and gradients lie as far from an f32 truth as the
# plain versions' (tests/test_torch_kernels_cuda.py, the bf16 tests).
TRAIN_LOSS_ATOL = {"train": 5e-4, "train_mha": 1.2e-3, "train_window": 5e-4}
TRAIN_GRAD_REL = 0.1
TRAIN_LAYERS = 8
# The key projection's bias shifts every score of a query row alike, which
# the softmax does not see: its gradient is 0 but for rounding noise
# (1.2e-10 in the f32 reference phase). So its relative gradient error
# between two roundings is noise over noise (0.9-1.8 in train_encoder),
# and AdamW steps it by the sign of that noise, differently on the card
# and the CPU: it is reported apart and held to the lr bound alone (the
# fused encoder's, ``fused_attn.attn.k_proj.bias``), or, where the noise
# is above AdamW's eps and each side steps it by about lr a step (BERT's
# ``self_attn.k_proj.bias``), to 2 x steps x lr.
NOISE_GRAD_PARAMS = ("attn.k_proj.bias",)
# train_encoder: 12 post-LN FusedTransformerEncoderLayers at BERT-base's
# widths (BertConfig's defaults: hidden 768, 12 heads, FFN 3072, GELU,
# dropout 0.1, 12 layers; LayerNorm eps the layer's own 1e-5), bf16,
# seeded; one forward+backward with the kernels against one with their
# plain versions, identical weights, batch and dropout draws: bf16
# roundings apart in each of 12 layers (the flash forward rounds each
# probability against the running max, the plain version against the
# final one). Readings: loss 3.6e-6 apart (of 2.0004); gradients 0.0103
# median, 0.117 worst (layer 11's q projection, whose gradient is small:
# near-uniform attention); the key bias apart. Limits about twice them.
ENC_LOSS_ATOL = 8e-6
ENC_GRAD_REL = 0.25
ENCODER = dict(layers=12, d_model=768, nhead=12, dim_feedforward=3072,
               dropout_rate=0.1, B=32, S=512, steps=5, lr=1e-4, seed=0)
# train_bert: BertForPretraining at BertConfig()'s BERT-base (vocab 30522,
# hidden 768, 12 layers, 12 heads, FFN 3072, GELU, dropout 0.1, 512
# positions), bf16, seeded, B=32, S=512, through
# bert_pretrain_step_factory (its AdamW defaults: lr 1e-4, weight decay
# 0.01, betas (0.9, 0.999)); one warm-up step, then 5 timed. One
# forward+backward with the multi-head flash kernels against one with
# their plain versions, identical weights, batch and dropout draws: bf16
# roundings apart in each of 12 layers, carried into bf16 MLM logits of
# size up to ~100 (tied N(0, 1) word embeddings). Readings: loss 0.0114
# apart (of 116.8; 9.7e-5 relative); gradients 0.0023 median, 0.0192
# worst (layer 11's q projection); the key bias apart
# (NOISE_GRAD_PARAMS). Limits about twice them (PERF.md §2).
BERT = dict(B=32, S=512, steps=5, warmup=1, seed=0, mlm_share=0.15)
BERT_LOSS_ATOL = 0.025
BERT_GRAD_REL = 0.04
# the small f32 BERT of the reference phase: head_dim 64 at S = 256, the
# flash gate's shape (card: the kernels; CPU: their plain versions)
BERT_SMALL = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                  num_attention_heads=2, intermediate_size=512,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  max_position_embeddings=256)

# train_resnet50: resnet50() at 1000 classes, bf16 (f32 masters and BN
# buffers), B=256 x 3 x 224 x 224, resnet_train_step_factory's defaults
RESNET = dict(B=256, hw=224, classes=1000, steps=5, warmup=1, seed=0)
# the reference phase's small vision models, card (cuDNN, TF32 off) vs CPU:
# the order of the f32 sums only. ResNet-18 runs at 64 x 64: at 32 x 32
# its last stage normalises 1 x 1 x 8 positions a channel, where a ReLU
# input within f32 noise of 0 falls to either side and moves a gradient
# by 0.5 % (tests/test_torch_resnet.py -s); at 64 x 64 f32 lies within
# 4e-6 of float64. Momentum SGD at lr 0.01: each step's noise is carried
# on in the velocity and grows with the step's size (a first run at lr
# 0.05, whose first step takes the loss from 3.29 to 0.03, moved 1.6 % of
# a parameter's elements beyond 1e-5). Logits within REF_ATOL; TRAIN_REF's
# rule for the losses, step 1's gradients and the parameters after 3
# steps (at most 1e-4 of a parameter's elements beyond 1e-5, none beyond
# lr); running statistics after one forward within 1e-5 + 1e-5 x |cpu|,
# the buffers after 3 steps (blends of three batches' statistics) within
# 1e-4 + 1e-5 x |cpu|.
VISION_SMALL = dict(B=8, hw=64, classes=10, lenet_B=16, lr=0.01, seed=21)
VISION_STATS_TOL = (1e-5, 1e-5)
VISION_BUFFER_TOL = (1e-4, 1e-5)

SOURCE = "paddle_tpu_torch/ops/kernels/paged_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:46"
GQA_SOURCE = "paddle_tpu_torch/ops/kernels/flash_attention_gqa.cu"
CE_SOURCE = "paddle_tpu_torch/ops/kernels/fused_ce.cu"
GQA_FWD_REPLACES = "paddle_tpu/ops/pallas/flash_attention_gqa.py:131"
GQA_BWD_REPLACES = "paddle_tpu/ops/pallas/flash_attention_gqa.py:177,216"
# multi-head flash: the grouped kernels at G = 1, for both of the TPU
# kernels' modes (K/V resident, K/V streamed)
MHA_FWD_REPLACES = "paddle_tpu/ops/pallas/flash_attention.py:218,353"
MHA_BWD_REPLACES = "paddle_tpu/ops/pallas/flash_attention.py:262,297,400,440"
SPLASH_SOURCE = "paddle_tpu_torch/ops/kernels/splash_attention.cu"
SPLASH_FWD_REPLACES = "paddle_tpu/ops/pallas/splash_attention.py:165,253"
SPLASH_BWD_REPLACES = "paddle_tpu/ops/pallas/splash_attention.py:215,313,357"
CE_FWD_REPLACES = "paddle_tpu/ops/pallas/fused_ce.py:33"
CE_BWD_REPLACES = "paddle_tpu/ops/pallas/fused_ce.py:45"
NORM_SOURCE = "paddle_tpu_torch/ops/kernels/layer_norm.cu"
LN_REPLACES = "paddle_tpu/ops/pallas/layer_norm.py:27"
RMS_REPLACES = "paddle_tpu/ops/pallas/layer_norm.py:37"
DLN_REPLACES = "paddle_tpu/ops/pallas/dropout_ln.py:28"
# norm kernels (LayerNorm, RMSNorm, dropout-add-LayerNorm) vs their plain
# versions on the same inputs: f32 statistics on both sides, apart by the
# order of the row sums; the output rounds to bf16 once (one ulp: 2^-7 of
# |want|) or stays f32 (1e-5)
NORM_TOL = {"bfloat16": (1e-5, 2 ** -7), "float32": (1e-5, 1e-5)}
# f32 operations per element, counted at the f32 rate for the bound
# (sum, deviation, square-add, scale, weight, bias; RMSNorm has no
# deviation or bias; dropout-add-LN adds the bits' conversion, the
# compare, the keep multiply, the division and the residual add)
NORM_FLOPS = {"ln": 7, "rms": 5, "dln": 12}
# dropout bits at the edges of the keep decision u = f32(bits) / 2^32 >= p
# (at p = 0.1, f32(p) * 2^32 = 429496736; bits from 2^31 up; near 2^32,
# which round to u = 1.0), written into row 0 of the kernel cases' bits
EDGE_BITS = [0, 1, 429496719, 429496720, 429496721, 429496735, 429496736,
             429496737, 2 ** 31 - 65, 2 ** 31 - 64, 2 ** 31 - 1, 2 ** 31,
             2 ** 31 + 1, 2 ** 32 - 129, 2 ** 32 - 128, 2 ** 32 - 1]


def emit(obj):
    print(json.dumps(obj), flush=True)


def _event_ms(fn, flush=None):
    """Device time of one call of ``fn()`` in ms. Before it the L2 is
    flushed and the stream is held busy by a spin kernel, so the host's
    enqueue of ``fn`` overlaps it and the events time the device alone."""
    if flush is not None:
        flush.zero_()
    torch.cuda._sleep(2_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def gpu_ms(fn, reps=REPS, flush=None):
    """Median device time of ``fn()`` in ms over ``reps`` calls timed by
    ``_event_ms``, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return statistics.median(_event_ms(fn, flush) for _ in range(reps))


# --- phase 1: build --------------------------------------------------------

# the 16-bit attention kernels of each library: forward, dq and dk/dv at
# head_dim 64, 128 and 256, in bfloat16 and float16 (mangled type names)
WGMMA_KERNELS = ("fwd", "dq", "dkv")
WGMMA_DIMS = (64, 128, 256)
WGMMA_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "f16"}


# the paged prefill instances: pools in bf16 and int8 (mangled), each at
# head_dim 64, 128 and 256
PREFILL_POOLS = {"13__nv_bfloat16": "bf16", "a": "int8"}


def _sass_counts(cuobjdump, lib, pattern, name):
    """{kernel name: HGMMA instructions in its SASS} for the functions of
    library ``lib`` whose mangled name ``pattern`` matches (``name`` makes
    the key from the match)."""
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = pattern.search(line)
            kernel = m and name(m)
            if kernel:
                counts[kernel] = 0
        elif kernel and "HGMMA" in line:
            counts[kernel] += 1
    return counts


def _hgmma_counts(_build):
    """HGMMA instructions (wgmma) in the SASS of each 16-bit attention
    kernel (fwd_mma, dq_mma, dkv_mma at every head_dim and element type)
    of the two attention libraries, and of each paged prefill instance
    (paged_prefill_mma over bf16 and int8 pools at every head_dim), read
    with cuobjdump beside nvcc. Raises if one is missing or has none."""
    import re
    from pathlib import Path

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    counts = {}
    pattern = re.compile(r"(fwd|dkv|dq)_mmaILi(\d+)E.*?("
                         + "|".join(WGMMA_TYPES) + ")")
    for lib in ("flash_attention_gqa", "splash_attention"):
        counts.update(_sass_counts(
            cuobjdump, _build.library_path(lib), pattern,
            lambda m: (f"{lib}:{m.group(1)}_mma<{m.group(2)}, "
                       f"{WGMMA_TYPES[m.group(3)]}>")))
    counts.update(_sass_counts(
        cuobjdump, _build.library_path("paged_attention"),
        re.compile(r"paged_prefill_mmaI(" + "|".join(PREFILL_POOLS)
                   + r")Li(\d+)E"),
        lambda m: (f"paged_attention:paged_prefill_mma<"
                   f"{PREFILL_POOLS[m.group(1)]}, {m.group(2)}>")))
    want = (2 * len(WGMMA_KERNELS) * len(WGMMA_DIMS) * len(WGMMA_TYPES)
            + len(PREFILL_POOLS) * len(WGMMA_DIMS))
    if len(counts) != want or not all(counts.values()):
        raise AssertionError(f"16-bit attention kernels missing or without "
                             f"wgmma (want {want}): {counts}")
    return counts


def phase_build():
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, log in logs.items():
        if log.strip():
            print(f"[nvcc {name}]\n{log}", file=sys.stderr)
    seconds = time.perf_counter() - t0
    emit({"phase": "build", "ok": True, "sources": _build.sources(),
          "seconds": seconds, "hgmma": _hgmma_counts(_build)})


# --- phase 2: the kernel against its plain version --------------------------

def _kernel_case(name, B, Hkv, G, D, ps, W, P, lens, start, C, kv_dtype,
                 seed, dev, flush, q_dtype="bfloat16"):
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
    q = torch.randn(q_shape, generator=g, device=dev).to(getattr(torch,
                                                                 q_dtype))
    if kv_dtype == "int8":
        k = torch.randint(-127, 128, (Hkv, P, ps, D), generator=g,
                          device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (Hkv, P, ps, D), generator=g,
                          device=dev, dtype=torch.int8)
        ks = torch.rand((Hkv, P, ps), generator=g, device=dev) * 0.02
        vs = torch.rand((Hkv, P, ps), generator=g, device=dev) * 0.02
        kv_bytes = 1 + 4 / D      # a code per element, a scale per slot
    else:
        kvt = getattr(torch, kv_dtype)
        k = torch.randn((Hkv, P, ps, D), generator=g, device=dev).to(kvt)
        v = torch.randn((Hkv, P, ps, D), generator=g, device=dev).to(kvt)
        ks = vs = None
        kv_bytes = kvt.itemsize
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
    by_instance = dict(pa.paged_attention.instance_launches)
    got = kernel()
    launched = pa.paged_attention.launches - before
    # the instance the kernel's entry reports it launched
    ran = [k for k, n in pa.paged_attention.instance_launches.items()
           if n != by_instance[k]]
    instance = ran[0] if len(ran) == 1 else ",".join(ran) or None
    n_split = (pa._decode_splits(B, Hkv, W, ps, pa._sm_count(
        torch.cuda.current_device()))[0] if instance == "split" else 0)
    # launched again on the same inputs: the same bits (no atomics)
    bitwise = bool(torch.equal(got, kernel()))
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    atol, rtol = PAGED_TOL[q_dtype]
    allowed = atol + rtol * want.float().abs()
    ok = launched == 1 and bitwise and bool(torch.all(err <= allowed))
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
              + 2 * q.numel() * q.dtype.itemsize     # q in, out back
              + 4 * (live_pages + B))                # page ids, lens
    flops = 4 * D * pairs                            # q.k and p.v
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    # the tensor cores' rate for 16-bit operands, f32's outside them
    t_ops = flops / (F32_FLOP_PER_S if "float32" in (q_dtype, kv_dtype)
                     else BF16_FLOP_PER_S) * 1e3
    return {"case": name, "ok": ok, "max_abs_err": float(err.max()),
            # the largest error over its limit, element by element
            "max_err_over_tol": float((err / allowed).max()),
            "atol": atol, "rtol": rtol,
            "instance": instance, "n_split": n_split,
            "bitwise_repeat": bitwise,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(bytes_), "flops": int(flops),
            "shape": {"B": B, "Hkv": Hkv, "rows": rows, "D": D, "ps": ps,
                      "W": W, "P": P, "q": q_dtype, "kv": kv_dtype}}


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


def _attention_ops(kind, causal, pat):
    """The wrappers of one attention kind at the given mask: (launch
    counts owner, fwd, bwd, the dq and dkv launchers alone, plain fwd,
    plain bwd), each over (q, k, v[, do, lse, delta])."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention_gqa")
    fm = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    sa = importlib.import_module("paddle_tpu_torch.ops.splash_attention")
    if kind == "splash":
        return (sa.splash_attention,
                lambda q, k, v: sa.splash_fwd(q, k, v, pat),
                lambda *a: sa.splash_bwd(*a, pat),
                lambda q, *a: sa._launch_dq(q, *a, pat, q.shape[-1] ** -0.5),
                lambda q, *a: sa._launch_dkv(q, *a, pat,
                                             q.shape[-1] ** -0.5),
                lambda q, k, v: sa._splash_fwd_plain(q, k, v, pat),
                lambda *a: sa._splash_bwd_plain(*a, pat))
    owner, fwd, bwd = ((fm.flash_attention, fm.mha_fwd, fm.mha_bwd)
                       if kind == "mha" else
                       (fa.grouped_flash_attention, fa.gqa_fwd, fa.gqa_bwd))
    return (owner,
            lambda q, k, v: fwd(q, k, v, causal),
            lambda *a: bwd(*a, causal),
            lambda q, *a: fa._launch_dq(q, *a, causal, q.shape[-1] ** -0.5,
                                        owner),
            lambda q, *a: fa._launch_dkv(q, *a, causal, q.shape[-1] ** -0.5,
                                         owner),
            lambda q, k, v: fa._gqa_fwd_plain(q, k, v, causal),
            lambda *a: fa._gqa_bwd_plain(*a, causal))


SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def _sdpa(q, k, v, causal, live, flush):
    """The library yardstick: ``F.scaled_dot_product_attention`` causal, or
    with the live pairs as a boolean ``attn_mask``, K/V repeated to the
    query heads where a backend refuses ``enable_gqa``. Every fused backend
    that takes the call is timed and the fastest is the yardstick (the
    unfused MATH backend only where none takes it). Returns (its forward
    ms, its backward ms, its backend, how the groups were given)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    G = q.shape[1] // k.shape[1]
    kw = {"is_causal": causal} if live is None else {"attn_mask": live}

    def caller(name, groups, q, k, v):
        if groups == "repeat":
            k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))

        def call():
            with sdpa_kernel([getattr(SDPBackend, name)]):
                return F.scaled_dot_product_attention(
                    q, k, v, enable_gqa=groups == "enable_gqa", **kw)
        return call

    best = None
    for names in (SDPA_BACKENDS, ("MATH",)):
        for name in names:
            for groups in (("enable_gqa", "repeat") if G > 1 else ("none",)):
                call = caller(name, groups, q, k, v)
                try:            # a backend refuses what it does not take
                    call()
                except RuntimeError:
                    continue
                ms = gpu_ms(call, flush=flush)
                if best is None or ms < best[0]:
                    best = (ms, name, groups)
                break
        if best is not None:
            break
    if best is None:
        raise RuntimeError("no SDPA backend took the yardstick's inputs")
    ms, name, groups = best
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o = caller(name, groups, qr, kr, vr)()
    bwd_ms = gpu_ms(lambda: torch.autograd.grad(o, (qr, kr, vr),
                                                torch.ones_like(o),
                                                retain_graph=True),
                    flush=flush)
    return ms, bwd_ms, name, groups


def _attention_case(name, kind, B, Hkv, G, Sq, Sk, D, dtype, seed, dev,
                    flush, causal=True, mask=None):
    """The forward kernel through its wrapper and the dq and dkv kernels
    through the backward wrapper (on the plain forward's lse and delta, so
    each kernel meets its plain version on the same inputs), at the given
    shapes; then times: each kernel, the plain versions, and SDPA's
    forward and backward as the yardstick. ``kind`` is "gqa", "mha" (the
    grouped kernels at G = 1, counted on ``flash_attention``) or "splash"
    (``mask`` = (block mask, block_q, block_k, window, q_offset))."""
    sa = importlib.import_module("paddle_tpu_torch.ops.splash_attention")
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((B, Hkv * G, Sq, D), generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, Hkv, Sk, D), generator=g, device=dev).to(dt)
            for _ in range(2))
    pat = None if mask is None else sa._pattern(q, k, mask[0], causal,
                                                *mask[1:])
    owner, fwd, bwd, dq, dkv, plain_fwd, plain_bwd = _attention_ops(
        kind, causal, pat)

    def counts():
        return owner.launches_fwd, owner.launches_dq, owner.launches_dkv

    n0 = counts()
    out, lse = fwd(q, k, v)
    n1 = counts()
    want_out, want_lse = plain_fwd(q, k, v)
    delta = (do.float() * want_out.float()).sum(-1)
    grads = bwd(q, k, v, do, want_lse, delta)
    n2 = counts()
    want_grads = plain_bwd(q, k, v, do, want_lse, delta)
    torch.cuda.synchronize()
    tol = GQA_TOL[dtype]
    checks = {"out": _check(out, want_out, *tol["out"]),
              "lse": _check(lse, want_lse, *LSE_TOL)}
    for n, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        checks[n] = _check(a, b, *tol["grad"])
    launched = (n1 == (n0[0] + 1, n0[1], n0[2])
                and n2 == (n1[0], n1[1] + 1, n1[2] + 1))
    # dq and dk/dv once more on the same inputs: the same bits (no atomics)
    again = (dq(q, k, v, do, want_lse, delta),
             *dkv(q, k, v, do, want_lse, delta))
    repeat = all(torch.equal(a, b) for a, b in zip(grads, again))
    checks["bitwise_repeat"] = (0.0, 0.0 if repeat else 2.0)
    del again
    ok = launched and all(r <= 1.0 for _, r in checks.values())
    if pat is None:
        live, pos = None, torch.arange(Sq, device=dev)
        per_head = int((torch.clamp(pos + 1, max=Sk) if causal
                        else torch.full_like(pos, Sk)).sum())
    else:
        live = sa._live_pairs(pat, Sq, Sk, dev)
        per_head = int(live.sum())
        # rows with no live key: exactly out 0 and lse NEG_INF
        empty = ~live.any(-1)
        exact = bool((lse[..., empty] == want_lse[..., empty]).all()
                     and not out[:, :, empty].any())
        checks["empty_rows"] = (0.0, 0.0 if exact else 2.0)
        ok = ok and exact
    del out, want_out, grads, want_grads

    times = {
        "ms_fwd": gpu_ms(lambda: fwd(q, k, v), flush=flush),
        "ms_dq": gpu_ms(lambda: dq(q, k, v, do, want_lse, delta),
                        flush=flush),
        "ms_dkv": gpu_ms(lambda: dkv(q, k, v, do, want_lse, delta),
                         flush=flush),
        "plain_ms_fwd": gpu_ms(lambda: plain_fwd(q, k, v), flush=flush),
        "plain_ms_bwd": gpu_ms(lambda: plain_bwd(q, k, v, do, want_lse,
                                                 delta), flush=flush)}
    (times["library_ms_fwd"], times["library_ms_bwd"], backend,
     groups) = _sdpa(q, k, v, causal, live, flush)

    # the work these inputs need: each live (query, key) pair once; each
    # input read once and each output written once
    pairs = B * Hkv * G * per_head
    # the 16-bit types' tensor-core peak is one (989 TFLOP/s dense)
    rate = F32_FLOP_PER_S if dtype == "float32" else BF16_FLOP_PER_S
    nq, nkv, rows = q.numel() * dt.itemsize, k.numel() * dt.itemsize, \
        B * Hkv * G * Sq * 4
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
    shape = {"B": B, "Hq": Hkv * G, "Hkv": Hkv, "Sq": Sq, "Sk": Sk, "D": D,
             "dtype": dtype, "causal": causal}
    if mask is not None:
        shape.update({"mask_blocks": list(mask[0].shape),
                      "block_q": mask[1], "block_k": mask[2],
                      "window": mask[3], "q_offset": mask[4]})
    return {"case": name, "ok": ok, "launched_once_each": launched,
            "checks": {n: {"max_abs_err": e, "max_err_over_tol": r}
                       for n, (e, r) in checks.items()},
            "tol": tol, **times, "library": {"sdpa_backend": backend,
                                             "groups": groups},
            "live_pairs": pairs, "bounds": bounds, "shape": shape}


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


def _library_kernels(fn):
    """How many device kernels one call of ``fn`` launches (a
    ``torch.profiler`` count), or None where the profiler sees none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())
    return n or None


def _norm_case(name, kind, N, H, dtype, seed, dev, flush, wdtype=None,
               p=0.1, training=True, eps=None):
    """One norm kernel through its public wrapper (``fused_layer_norm``,
    ``fused_rms_norm``, ``fused_dropout_add_layer_norm``; ``kind`` "ln",
    "rms", "dln") against its plain version on the same inputs; for a
    dropout-add-LN call that drops, also the keep mask, exactly (x = 100,
    |res| < 1, w = 1, b = 0: the output is above 0 exactly where x was
    kept), against the plain version and the rule. Then times beside the
    plain version, the library call (``F.layer_norm``, ``F.rms_norm``;
    none for dropout-add-LN) and the byte bound."""
    import torch.nn.functional as F

    lnm = importlib.import_module("paddle_tpu_torch.ops.layer_norm")
    dl = importlib.import_module("paddle_tpu_torch.ops.dropout_ln")
    dt, wdt = getattr(torch, dtype), getattr(torch, wdtype or dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((N, H), generator=g, device=dev) * 2 + 0.5).to(dt)
    w = (1 + 0.5 * torch.randn(H, generator=g, device=dev)).to(wdt)
    b = torch.randn(H, generator=g, device=dev).to(wdt)
    xb, wb = x.numel() * dt.itemsize, H * wdt.itemsize
    library = None
    dropping = kind == "dln" and training and p > 0
    if kind == "ln":
        eps = 1e-5 if eps is None else eps
        owner = lnm.fused_layer_norm

        def kernel():
            return lnm.fused_layer_norm(x, w, b, eps)

        def plain():
            return lnm._ln_plain(x, w, b, eps)

        def library():
            return F.layer_norm(x, (H,), w.to(dt), b.to(dt), eps)
        nbytes = 2 * xb + 2 * wb
    elif kind == "rms":
        eps = 1e-6 if eps is None else eps
        owner = lnm.fused_rms_norm

        def kernel():
            return lnm.fused_rms_norm(x, w, eps)

        def plain():
            return lnm._rms_plain(x, w, eps)
        if hasattr(F, "rms_norm"):
            def library():
                return F.rms_norm(x, (H,), w.to(dt), eps)
        nbytes = 2 * xb + wb
    else:
        eps = 1e-5 if eps is None else eps
        owner = dl.fused_dropout_add_layer_norm
        res = torch.randn((N, H), generator=g, device=dev).to(dt)
        bits = torch.empty((N, H), dtype=torch.int32, device=dev).random_(
            -2 ** 31, 2 ** 31, generator=g)
        edges = torch.tensor(EDGE_BITS, dtype=torch.int64)[:H]
        bits[0, :edges.numel()] = edges.to(torch.int32).to(dev)  # wraps

        def kernel():
            return dl.fused_dropout_add_layer_norm(x, res, w, b, p, eps,
                                                   training, bits=bits)

        def plain():
            return dl._forward_plain(x, res, w, b, bits, p, eps, training)
        nbytes = 3 * xb + 2 * wb + (4 * N * H if dropping else 0)

    before = owner.launches
    got = kernel()
    launched = owner.launches - before
    want = plain()
    torch.cuda.synchronize()
    max_err, ratio = _check(got, want, *NORM_TOL[dtype])
    ok = launched == 1 and ratio <= 1.0
    out = {}
    if dropping:
        xs = torch.full_like(x, 100.0)
        rs = (torch.rand((N, H), generator=g, device=dev) * 2 - 1).to(dt)
        ones, zeros = torch.ones_like(w), torch.zeros_like(b)
        k_keep = dl.fused_dropout_add_layer_norm(
            xs, rs, ones, zeros, p, eps, training, bits=bits) > 0
        p_keep = dl._forward_plain(xs, rs, ones, zeros, bits, p, eps,
                                   training) > 0
        rule = dl._uniform(bits) >= p
        out["same_keep"] = bool(torch.equal(k_keep, rule)
                                and torch.equal(p_keep, rule))
        out["keep_fraction"] = float(rule.float().mean())
        ok = ok and out["same_keep"]
    del got, want
    out.update({"ms": gpu_ms(kernel, flush=flush),
                "plain_ms": gpu_ms(plain, flush=flush),
                "library_ms": None if library is None
                else gpu_ms(library, flush=flush),
                "library_kernels": None if library is None
                else _library_kernels(library)})
    return {"case": name, "kind": kind, "ok": ok,
            "launched_once": launched == 1, "max_abs_err": max_err,
            "max_err_over_tol": ratio, "tol": NORM_TOL[dtype], **out,
            **_bound(nbytes, NORM_FLOPS[kind] * N * H, F32_FLOP_PER_S),
            "shape": {"N": N, "H": H, "x": dtype, "w": wdtype or dtype,
                      "eps": eps, **({"p": p, "training": training}
                                     if kind == "dln" else {})}}


def _norm_cases():
    """(name, kind, N, H, dtype, keywords): first each kernel at the shape
    that heads its row of PERF.md (rows 12-13 at Llama-3-8B's width, row
    14 at the train_encoder phase's call), then the encoder's width, f32,
    f32 weights under bf16 x with an odd width (the scalar path), a width
    past the registers (rows re-read from L2), BERT's eps of 1e-12; for
    row 14: eval, f32, p = 0.5, a ragged N (the reference's dense
    fallback) and an odd width."""
    cases = []
    for kind in ("ln", "rms"):
        cases += [(f"{kind}_N8192_H4096/bfloat16", kind, 8192, 4096,
                   "bfloat16", {}),
                  (f"{kind}_N16384_H768/bfloat16", kind, 16384, 768,
                   "bfloat16", {}),
                  (f"{kind}_N16384_H768/float32", kind, 16384, 768,
                   "float32", {}),
                  (f"{kind}_N1000_H100/bfloat16_w_float32", kind, 1000, 100,
                   "bfloat16", {"wdtype": "float32"}),
                  (f"{kind}_N64_H20000/bfloat16", kind, 64, 20000,
                   "bfloat16", {}),
                  (f"{kind}_N4096_H768_eps1e-12/float32", kind, 4096, 768,
                   "float32", {"eps": 1e-12})]
    cases += [("dln_N16384_H768_p0.1/bfloat16", "dln", 16384, 768,
               "bfloat16", {}),
              ("dln_N16384_H768_eval/bfloat16", "dln", 16384, 768,
               "bfloat16", {"training": False}),
              ("dln_N16384_H768_p0.1/float32", "dln", 16384, 768,
               "float32", {}),
              ("dln_N16384_H768_p0.5/bfloat16", "dln", 16384, 768,
               "bfloat16", {"p": 0.5}),
              ("dln_N1000_H768_ragged/bfloat16", "dln", 1000, 768,
               "bfloat16", {}),
              ("dln_N130_H100/bfloat16", "dln", 130, 100, "bfloat16", {})]
    return cases


def _interleaved_ms(fns, flush, reps=REPS):
    """Device ms of each of ``fns`` ({name: fn}), called in turns
    ``reps`` times, each call timed alone by ``_event_ms``: {name:
    median, min, max, first and third quartile}."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            times[name].append(_event_ms(fn, flush))
    out = {}
    for name, ts in times.items():
        q1, _, q3 = statistics.quantiles(ts, n=4)
        out[name] = {"median": statistics.median(ts), "min": min(ts),
                     "max": max(ts), "q1": q1, "q3": q3}
    return out


def _ln_against_library(N, H, seed, dev, flush):
    """Row 12 (``fused_layer_norm``) against ``F.layer_norm`` on the same
    bf16 inputs, ``REPS`` calls of each in turns: whether the kernel is
    slower beyond the noise, i.e. its first quartile above the library's
    third (their middle halves do not overlap)."""
    import torch.nn.functional as F

    lnm = importlib.import_module("paddle_tpu_torch.ops.layer_norm")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((N, H), generator=g, device=dev) * 2 + 0.5) \
        .to(torch.bfloat16)
    w = (1 + 0.5 * torch.randn(H, generator=g, device=dev)) \
        .to(torch.bfloat16)
    b = torch.randn(H, generator=g, device=dev).to(torch.bfloat16)
    t = _interleaved_ms({
        "fused_layer_norm": lambda: lnm.fused_layer_norm(x, w, b, 1e-5),
        "F.layer_norm": lambda: F.layer_norm(x, (H,), w, b, 1e-5)}, flush)
    k, lib = t["fused_layer_norm"], t["F.layer_norm"]
    return {"case": f"ln_interleaved_N{N}_H{H}/bfloat16", "reps": REPS,
            **t, "median_ratio": k["median"] / lib["median"],
            "kernel_slower_beyond_noise": k["q1"] > lib["q3"],
            "library_slower_beyond_noise": lib["q1"] > k["q3"]}


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
    # head_dim 256: decode at 2 kv heads of 4 (G = 2), ragged lengths
    for qt in ("bfloat16", "float32"):
        cases.append(_kernel_case(
            f"decode_D256/{qt}", 8, 2, 2, 256, ps, 8, 8 * 8 + 1,
            [1, 512, 300, 0, 64, 129, 511, 7], None, 1, qt, 3, dev, flush,
            q_dtype=qt))
    # decode where the one-block-per-(sequence, kv head) grid starves: one
    # 16,384-token sequence (8 blocks); B=32 at ragged lengths up to 2048
    # (a pad row, one full table); G = 1 at Llama-2-7B's 32 kv heads; G = 8
    cases.append(_kernel_case("decode_16k/bfloat16", 1, Hkv, G, D, ps, 256,
                              257, [16384], None, 1, "bfloat16", 4, dev,
                              flush))
    lens32 = np.random.default_rng(5).integers(1, 2049, 32).tolist()
    lens32[:2] = [0, 2048]
    cases.append(_kernel_case("decode_B32/bfloat16", 32, Hkv, G, D, ps, W,
                              32 * W + 1, lens32, None, 1, "bfloat16", 5,
                              dev, flush))
    cases.append(_kernel_case("decode_G1_Hkv32/bfloat16", 8, 32, 1, D, ps,
                              W, P, dec_lens, None, 1, "bfloat16", 6, dev,
                              flush))
    cases.append(_kernel_case("decode_G8/bfloat16", 8, 4, 8, D, ps, W, P,
                              dec_lens, None, 1, "bfloat16", 7, dev, flush))
    # a 256-token chunk at start 512 (712 keys) at other shapes: Llama-2-7B's
    # 32 kv heads of one query head each, G = 8 over 4 kv heads, head_dim 64
    # and 256, pages of 16, and four sequences of ragged lengths (a pad row,
    # one shorter than the chunk's start, one past its end); then float32,
    # which keeps the row-tile kernel
    for name, B, Hkv_, G_, D_, ps_, lens in (
            ("prefill_G1_Hkv32/bfloat16", 1, 32, 1, D, ps, [712]),
            ("prefill_G8/bfloat16", 1, 4, 8, D, ps, [712]),
            ("prefill_D64/bfloat16", 1, Hkv, G, 64, ps, [712]),
            ("prefill_D256/bfloat16", 1, Hkv, G, 256, ps, [712]),
            ("prefill_ps16/bfloat16", 1, Hkv, G, D, 16, [712]),
            ("prefill_B4_ragged/bfloat16", 4, Hkv, G, D, ps,
             [0, 300, 700, 2048])):
        W_ = 2048 // ps_
        cases.append(_kernel_case(name, B, Hkv_, G_, D_, ps_, W_, B * W_ + 1,
                                  lens, 512, 256, "bfloat16", 20 + len(cases),
                                  dev, flush))
    cases.append(_kernel_case("prefill_c256_start512/float32", 1, Hkv, G, D,
                              ps, W, P, [712], 512, 256, "float32", 19, dev,
                              flush, q_dtype="float32"))
    # each call's instance, as the kernel's entry reported it: decode the
    # split one, a bf16 chunk the tensor cores', float32 the row-tile kernel
    for c in cases:
        want = ("split" if c["case"].startswith("decode")
                else "mma" if c["shape"]["q"] == "bfloat16" else "rows")
        c["instance_expected"] = want
        c["ok"] = c["ok"] and c["instance"] == want
    for c in cases:
        emit({"phase": "kernel", **c})
    gqa = [_attention_case("gqa_B2_S4096_D128/bfloat16", "gqa", 2, 8, 4,
                           4096, 4096, 128, "bfloat16", 7, dev, flush),
           _attention_case("gqa_B2_S256_D64/float32", "gqa", 2, 2, 2, 256,
                           256, 64, "float32", 8, dev, flush)]
    # head_dim 256, and kv groups that do not divide the row tile (64 rows
    # in the 16-bit kernels, 32 in float32): one query head a tile
    gqa += [_attention_case(name, "gqa", *shape, seed, dev, flush,
                            causal=causal)
            for seed, (name, shape, causal) in
            enumerate(_shape_cases(), start=50)]
    ce = [_ce_case(8192, 128256, 5, dev, flush)]
    # the grouped kernels at train_long's call: Llama-3.2-3B's 24 / 8 heads
    # (G = 3) at S=8192
    gqa_long = [_attention_case("gqa_G3_B1_S8192_D128/bfloat16", "gqa", 1, 8,
                                3, 8192, 8192, 128, "bfloat16", 80, dev,
                                flush)]
    for c in gqa + ce + gqa_long:
        emit({"phase": "kernel", **c})
    mha = [_attention_case("mha_B2_S4096_D128/bfloat16", "mha", 2, 32, 1,
                           4096, 4096, 128, "bfloat16", 9, dev, flush),
           _attention_case("mha_B2_S256_D64/float32", "mha", 2, 4, 1, 256,
                           256, 64, "float32", 10, dev, flush),
           _attention_case("mha_B2_Sq1024_Sk2048_D128/bfloat16", "mha", 2,
                           8, 1, 1024, 2048, 128, "bfloat16", 11, dev,
                           flush),
           # float16, as scaled_dot_product_attention sends it
           _attention_case("mha_B2_S2048_D128/float16", "mha", 2, 8, 1,
                           2048, 2048, 128, "float16", 60, dev, flush),
           _attention_case("mha_B2_S1024_D64_noncausal/float16", "mha", 2,
                           8, 1, 1024, 1024, 64, "float16", 61, dev, flush,
                           causal=False)]
    for c in mha:
        emit({"phase": "kernel", **c})
    splash = [_attention_case(name, "splash", *shape, seed, dev, flush,
                              causal=causal, mask=mask)
              for seed, (name, shape, causal, mask) in
              enumerate(_splash_cases(), start=12)]
    for c in splash:
        emit({"phase": "kernel", **c})
    # the multi-head kernels at the train_encoder phase's call: BERT-base
    # width, non-causal
    mha_enc = [_attention_case("mha_encoder_B32_S512_D64_noncausal/bfloat16",
                               "mha", 32, 12, 1, 512, 512, 64, "bfloat16",
                               30, dev, flush, causal=False)]
    emit({"phase": "kernel", **mha_enc[0]})
    norm = []
    for seed, (name, kind, N, H, dtype, kw) in enumerate(_norm_cases(),
                                                          start=40):
        norm.append(_norm_case(name, kind, N, H, dtype, seed, dev, flush,
                               **kw))
        emit({"phase": "kernel", **norm[-1]})
    # row 12 against F.layer_norm in turns, at Llama-3-8B's width and
    # the encoder's
    ln_retime = [_ln_against_library(N, H, 70 + i, dev, flush)
                 for i, (N, H) in enumerate(((8192, 4096), (16384, 768)))]
    for c in ln_retime:
        emit({"phase": "kernel", **c})
    bad = [c["case"] for c in cases + gqa + ce + gqa_long + mha + splash
           + mha_enc + norm if not c["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"or did not launch once: {bad}")
    del flush
    torch.cuda.empty_cache()
    return {"paged": cases, "gqa": gqa, "ce": ce, "gqa_long": gqa_long,
            "mha": mha,
            "splash": splash, "mha_encoder": mha_enc, "norm": norm,
            "ln_retime": ln_retime}


def _shape_cases():
    """(name, (B, Hkv, G, Sq, Sk, D, dtype), causal) of the grouped
    kernels at head_dim 256 (bf16 and f32) and at kv groups that do not
    divide the row tile: G = 3 and 6 in bf16, 64 in f32."""
    return [
        ("gqa_B2_S1024_D256/bfloat16", (2, 2, 2, 1024, 1024, 256,
                                        "bfloat16"), True),
        ("gqa_B1_S256_D256/float32", (1, 2, 2, 256, 256, 256, "float32"),
         True),
        ("gqa_G3_B2_S1024_D128/bfloat16", (2, 2, 3, 1024, 1024, 128,
                                           "bfloat16"), True),
        ("gqa_G6_B1_S1024_D64_noncausal/bfloat16", (1, 2, 6, 1024, 1024, 64,
                                                    "bfloat16"), False),
        ("gqa_G64_B1_S256_D64/float32", (1, 1, 64, 256, 256, 64,
                                         "float32"), True),
    ]


def _random_mask(nq, nk, seed, empty_row):
    bm = np.random.default_rng(seed).random((nq, nk)) < 0.5
    bm[:, 0] = True
    bm[empty_row] = False
    return bm


def _splash_cases():
    """(name, (B, Hkv, G, Sq, Sk, D, dtype), causal, (block mask, block_q,
    block_k, window, q_offset)): first the train_window phase's call (the
    Mistral band at S=8192, the model's mask of 128-blocks), then G = 1
    banded, a random mask with an empty block row, a shifted query frame,
    mask blocks smaller than the kernels' tiles, f32, a kv group of 3
    (one query head a tile) and head_dim 256 in bf16 and f32."""
    from paddle_tpu_torch.ops.splash_attention import banded_block_mask

    def band(S, b, w):
        return banded_block_mask(S, S, b, b, w), b, b, w, 0

    return [
        ("splash_mistral_B1_S8192_W4096/bfloat16",
         (1, 8, 4, 8192, 8192, 128, "bfloat16"), True, band(8192, 128, 4096)),
        ("splash_g1_B2_S2048_W512/bfloat16",
         (2, 8, 1, 2048, 2048, 128, "bfloat16"), True, band(2048, 64, 512)),
        ("splash_random_empty_row_S1024/bfloat16",
         (2, 4, 2, 1024, 1024, 64, "bfloat16"), False,
         (_random_mask(8, 8, 0, 3), 128, 128, None, 0)),
        ("splash_q_offset_Sq512_Sk1024/bfloat16",
         (2, 4, 4, 512, 1024, 128, "bfloat16"), True,
         (np.ones((4, 8), bool), 128, 128, 300, 512)),
        ("splash_blocks16_S1024/bfloat16",
         (1, 4, 4, 1024, 1024, 128, "bfloat16"), True,
         (_random_mask(64, 64, 1, 7), 16, 16, None, 0)),
        ("splash_band_S256_D64/float32",
         (2, 2, 2, 256, 256, 64, "float32"), True, band(256, 32, 100)),
        ("splash_g3_B1_S2048_W512/bfloat16",
         (1, 2, 3, 2048, 2048, 128, "bfloat16"), True, band(2048, 64, 512)),
        ("splash_band_S1024_D256/bfloat16",
         (1, 2, 2, 1024, 1024, 256, "bfloat16"), True, band(1024, 64, 300)),
        ("splash_band_S256_D256/float32",
         (1, 2, 2, 256, 256, 256, "float32"), True, band(256, 32, 100)),
    ]


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


def _train_small(dev, state, cfg, tokens, labels, remat=False,
                 chunked_vocab_ce=None, offload_moments=False):
    """The tiny train step on ``dev`` from ``state`` with the factory's
    options: the gradients of the first step's loss, the losses of 3 steps
    and the parameters after them (each on the CPU), and whether every
    moment is pinned host memory."""
    from paddle_tpu_torch.models.nlp import (LlamaForCausalLM,
                                             llama_train_step_factory,
                                             load_numpy_state_dict,
                                             param_views)
    from paddle_tpu_torch.models.nlp.llama_functional import loss_fn

    model = load_numpy_state_dict(LlamaForCausalLM(cfg, device=dev), state)
    params, opt, step = llama_train_step_factory(
        model, learning_rate=TRAIN_REF["lr"], remat=remat, device=dev,
        offload_moments=offload_moments, chunked_vocab_ce=chunked_vocab_ce)
    tokens, labels = tokens.to(dev), labels.to(dev)
    outer, layers = param_views(params, cfg.num_hidden_layers)
    loss = loss_fn(cfg, outer, layers, tokens, labels, remat,
                   chunked_vocab_ce)
    grads = {k: g.cpu() for k, g in
             zip(params, torch.autograd.grad(loss, list(params.values())))}
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, tokens, labels)
        losses.append(float(loss))
    torch.cuda.synchronize()
    pinned = all(m.is_pinned() for name in ("m", "v")
                 for m in opt[name].values())
    return (losses, grads, {k: p.detach().cpu() for k, p in params.items()},
            pinned)


def _train_agree(card, cpu):
    """Card against CPU runs of ``_train_small`` under ``TRAIN_REF``: (the
    readings, ok)."""
    loss_diff = max(abs(a - b) for a, b in zip(card[0], cpu[0]))
    grad_diff = max(float((card[1][k] - cpu[1][k]).abs().max())
                    for k in cpu[1])
    param_max, param_frac = 0.0, 0.0
    for k in cpu[2]:
        d = (card[2][k] - cpu[2][k]).abs()
        param_max = max(param_max, float(d.max()))
        param_frac = max(param_frac,
                         float((d > TRAIN_REF["param"]).float().mean()))
    ok = (loss_diff <= TRAIN_REF["loss"] and grad_diff <= TRAIN_REF["grad"]
          and param_frac <= TRAIN_REF["param_frac"]
          and param_max <= TRAIN_REF["lr"] and card[0][-1] < card[0][0])
    return ({"train_losses_card": card[0], "train_losses_cpu": cpu[0],
             "train_loss_max_diff": loss_diff,
             "train_grad_max_diff": grad_diff,
             "train_param_max_diff": param_max,
             "train_param_frac_over_atol": param_frac,
             "train_tol": TRAIN_REF}, ok)


def _encoder_small(dev, state, x, tgt):
    """The small f32 encoder on ``dev`` from ``state`` at dropout 0: its
    output, the gradients of the first step's loss (None for an unused
    parameter), the losses of 3 steps and the parameters after them
    (each on the CPU)."""
    from paddle_tpu_torch.nn import load_numpy_state_dict

    stack = load_numpy_state_dict(
        _encoder(dev, 2, 128, 2, 512, 0.0, None, torch.float32), state)
    x, tgt = x.to(dev), tgt.to(dev)
    h = x
    for layer in stack:
        h = layer(h)
    out = h.detach().cpu()
    loss = _encoder_loss(stack, x, tgt)
    grads = {k: None if g is None else g.cpu() for (k, _), g in zip(
        stack.named_parameters(),
        torch.autograd.grad(loss, list(stack.parameters()),
                            allow_unused=True))}
    losses, _, _ = _encoder_train(stack, x, tgt, 3, TRAIN_REF["lr"])
    return out, losses, grads, {k: p.detach().cpu()
                                for k, p in stack.named_parameters()}


def _reference_encoder(dev):
    """A small f32 post-LN encoder (2 layers, d = 128, 2 heads, FFN 512,
    B = 2, S = 256: flash-eligible) on the card (the kernels) and on the
    CPU (the plain versions), from the same weights: the output within
    ``REF_ATOL``, then 3 training steps under ``TRAIN_REF`` (the key bias
    under the lr bound only: ``NOISE_GRAD_PARAMS``)."""
    from paddle_tpu_torch.core import Generator

    cpu = torch.device("cpu")
    state = {k: v.numpy() for k, v in _encoder(
        cpu, 2, 128, 2, 512, 0.0, Generator(11), torch.float32)
        .state_dict().items()}
    rng = np.random.default_rng(13)
    x, tgt = (torch.from_numpy(rng.standard_normal((2, 256, 128))
                               .astype(np.float32)) for _ in range(2))
    card = _encoder_small(dev, state, x, tgt)
    host = _encoder_small(cpu, state, x, tgt)
    out_diff = float((card[0] - host[0]).abs().max())
    loss_diff = max(abs(a - b) for a, b in zip(card[1], host[1]))
    unused = sorted(k for k, g in host[2].items() if g is None)
    grad_diff = max(float((card[2][k] - g).abs().max())
                    for k, g in host[2].items() if g is not None)
    param_max, param_frac = 0.0, 0.0
    for k in host[3]:
        d = (card[3][k] - host[3][k]).abs()
        param_max = max(param_max, float(d.max()))
        if not k.endswith(NOISE_GRAD_PARAMS):
            param_frac = max(param_frac,
                             float((d > TRAIN_REF["param"]).float().mean()))
    noise_grad = max(float(g.abs().max()) for k, g in host[2].items()
                     if k.endswith(NOISE_GRAD_PARAMS))
    ok = (out_diff <= REF_ATOL and loss_diff <= TRAIN_REF["loss"]
          and grad_diff <= TRAIN_REF["grad"]
          and param_frac <= TRAIN_REF["param_frac"]
          and param_max <= TRAIN_REF["lr"] and card[1][-1] < card[1][0]
          and unused == sorted(k for k, g in card[2].items() if g is None))
    return {"encoder_out_max_diff": out_diff,
            "encoder_losses_card": card[1], "encoder_losses_cpu": host[1],
            "encoder_loss_max_diff": loss_diff,
            "encoder_grad_max_diff": grad_diff,
            "encoder_param_max_diff": param_max,
            "encoder_param_frac_over_atol": param_frac,
            "encoder_noise_grad_max": noise_grad,
            "encoder_unused_params": unused, "encoder_ok": ok}


def _bert_small(dev, state, batch, mask):
    """The small f32 BERT on ``dev`` from ``state`` at dropout 0: its MLM
    and NSP logits without and with ``mask``, the gradients of the first
    step's loss, the losses of 3 factory steps and the parameters after
    them (each on the CPU)."""
    from paddle_tpu_torch.models.nlp import (BertConfig, BertForPretraining,
                                             bert_pretrain_step_factory)
    from paddle_tpu_torch.models.nlp.bert import pretrain_loss
    from paddle_tpu_torch.nn import load_numpy_state_dict

    model = load_numpy_state_dict(
        BertForPretraining(BertConfig(**BERT_SMALL), device=dev), state)
    batch = [t.to(dev) for t in batch]
    with torch.no_grad():
        outs = [t.cpu() for t in (*model(*batch[:2]),
                                  *model(*batch[:2], mask.to(dev)))]
    params, opt, step = bert_pretrain_step_factory(
        model, None, learning_rate=TRAIN_REF["lr"], device=dev)
    loss = pretrain_loss(model, *batch)
    grads = {k: g.cpu() for k, g in
             zip(params, torch.autograd.grad(loss, list(params.values())))}
    losses = [float(step(params, opt, *batch)[2]) for _ in range(3)]
    return outs, losses, grads, {k: p.detach().cpu()
                                 for k, p in params.items()}


def _reference_bert(dev):
    """A small f32 ``BertForPretraining`` (``BERT_SMALL``: hidden 128, 2
    heads, head_dim 64, 2 layers; B = 2, S = 256: flash-eligible) on the
    card (the kernels) and on the CPU (the plain versions), from the same
    weights: MLM and NSP logits within ``REF_ATOL``, without a mask and
    with one (the dense path); then 3 factory steps under ``TRAIN_REF``
    (the key bias, whose gradient is noise: 2 x 3 x lr)."""
    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.models.nlp import BertConfig, BertForPretraining

    cfg = BertConfig(**BERT_SMALL)
    state = {k: v.numpy() for k, v in BertForPretraining(
        cfg, device="cpu", generator=Generator(11)).state_dict().items()}
    B, S = 2, 256
    rng = np.random.default_rng(14)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    types = np.broadcast_to(np.arange(S) >= S // 2, (B, S)).astype(np.int64)
    mlm = np.where(rng.random((B, S)) < BERT["mlm_share"],
                   rng.integers(0, cfg.vocab_size, (B, S)), -100)
    nsp = rng.integers(0, 2, (B,))
    mask = np.ones((B, S), np.int64)
    mask[1, 3 * S // 4:] = 0
    batch = [torch.from_numpy(a) for a in (ids, types, mlm, nsp)]
    card = _bert_small(dev, state, batch, torch.from_numpy(mask))
    host = _bert_small(torch.device("cpu"), state, batch,
                       torch.from_numpy(mask))
    out_diff = [float((a - b).abs().max()) for a, b in zip(card[0], host[0])]
    loss_diff = max(abs(a - b) for a, b in zip(card[1], host[1]))
    grad_diff = max(float((card[2][k] - g).abs().max())
                    for k, g in host[2].items())
    param_max, param_frac, noise_max = 0.0, 0.0, 0.0
    for k in host[3]:
        d = (card[3][k] - host[3][k]).abs()
        if k.endswith(NOISE_GRAD_PARAMS):
            noise_max = max(noise_max, float(d.max()))
            continue
        param_max = max(param_max, float(d.max()))
        param_frac = max(param_frac,
                         float((d > TRAIN_REF["param"]).float().mean()))
    ok = (max(out_diff) <= REF_ATOL and loss_diff <= TRAIN_REF["loss"]
          and grad_diff <= TRAIN_REF["grad"]
          and param_frac <= TRAIN_REF["param_frac"]
          and param_max <= TRAIN_REF["lr"]
          and noise_max <= 2 * 3 * TRAIN_REF["lr"]
          and card[1][-1] < card[1][0])
    return {"bert_config": BERT_SMALL, "bert_B": B, "bert_S": S,
            "bert_out_max_diff": dict(zip(
                ("mlm", "nsp", "mlm_masked", "nsp_masked"), out_diff)),
            "bert_losses_card": card[1], "bert_losses_cpu": host[1],
            "bert_loss_max_diff": loss_diff,
            "bert_grad_max_diff": grad_diff,
            "bert_param_max_diff": param_max,
            "bert_param_frac_over_atol": param_frac,
            "bert_noise_param_max_diff": noise_max, "bert_ok": ok}


def _vision_small(dev, state, make, x, y):
    """A small f32 vision model on ``dev`` from ``state``: its train-mode
    logits and running statistics after them, the gradients of the first
    step's loss, then the losses of 3 factory steps and the parameters,
    velocities and buffers after them (each on the CPU)."""
    from paddle_tpu_torch.nn import load_numpy_state_dict
    from paddle_tpu_torch.vision.models import resnet_train_step_factory

    model = load_numpy_state_dict(make(dev), state).train()
    x, y = x.to(dev), y.to(dev)
    with torch.no_grad():
        logits = model(x).cpu()
    stats = {k: v.cpu() for k, v in model.state_dict().items()
             if k.endswith(("_mean", "_variance"))}
    model = load_numpy_state_dict(make(dev), state)
    params, bufs, opt, step = resnet_train_step_factory(
        model, learning_rate=VISION_SMALL["lr"], device=dev)
    logp = torch.log_softmax(model.train()(x).float(), -1)
    loss = -logp.gather(-1, y[:, None])[:, 0].mean()
    grads = {k: g.cpu() for k, g in
             zip(params, torch.autograd.grad(loss, list(params.values())))}
    load_numpy_state_dict(model, state)     # the forward above blended
    losses = [float(step(params, bufs, opt, x, y)[3]) for _ in range(3)]
    return (logits, stats, grads, losses,
            {k: p.detach().cpu() for k, p in params.items()},
            {k: v.cpu() for k, v in opt["velocity"].items()},
            {k: b.cpu() for k, b in bufs.items()})


def _reference_vision(dev):
    """The small f32 ResNet-18 and LeNet on the card and on the CPU from
    the same weights (``VISION_SMALL``), and the max-pool tie case."""
    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision import datasets
    from paddle_tpu_torch.vision.models import LeNet, resnet18

    v = VISION_SMALL
    cpu = torch.device("cpu")
    rng = np.random.default_rng(v["seed"])
    templates = rng.normal(0, 1, (v["classes"], 3, v["hw"], v["hw"]))
    y = rng.integers(0, v["classes"], v["B"])
    x = (templates[y] + 0.3 * rng.normal(0, 1, (v["B"], 3, v["hw"],
                                                 v["hw"])))
    digits = datasets.MNIST(mode="test")
    cases = {
        "resnet18": (lambda d: resnet18(num_classes=v["classes"], device=d,
                                        generator=Generator(v["seed"])),
                     torch.from_numpy(x.astype(np.float32)),
                     torch.from_numpy(y)),
        "lenet": (lambda d: LeNet(device=d, generator=Generator(v["seed"])),
                  torch.from_numpy(np.stack([digits[i][0] for i in
                                             range(v["lenet_B"])])),
                  torch.from_numpy(digits.labels[:v["lenet_B"]]))}
    out, ok = {}, True
    for name, (make, xs, ys) in cases.items():
        state = {k: t.numpy() for k, t in make(cpu).state_dict().items()}
        card = _vision_small(dev, state, make, xs, ys)
        host = _vision_small(cpu, state, make, xs, ys)
        logit_diff = float((card[0] - host[0]).abs().max())
        stat_over = max([float(((card[1][k] - t).abs() / (
            VISION_STATS_TOL[0] + VISION_STATS_TOL[1] * t.abs())).max())
            for k, t in host[1].items()], default=0.0)
        grad_diff = max(float((card[2][k] - g).abs().max())
                        for k, g in host[2].items())
        loss_diff = max(abs(a - b) for a, b in zip(card[3], host[3]))
        param_max, param_frac = 0.0, 0.0
        for k, t in host[4].items():
            d = (card[4][k] - t).abs()
            param_max = max(param_max, float(d.max()))
            param_frac = max(param_frac,
                             float((d > TRAIN_REF["param"]).float().mean()))
        vel_diff = max(float((card[5][k] - t).abs().max())
                       for k, t in host[5].items())
        buf_over = max([float(((card[6][k] - t).abs() / (
            VISION_BUFFER_TOL[0] + VISION_BUFFER_TOL[1] * t.abs())).max())
            for k, t in host[6].items()], default=0.0)
        case_ok = (logit_diff <= REF_ATOL and stat_over <= 1
                   and grad_diff <= TRAIN_REF["grad"]
                   and loss_diff <= TRAIN_REF["loss"]
                   and param_frac <= TRAIN_REF["param_frac"]
                   and param_max <= VISION_SMALL["lr"]
                   and buf_over <= 1 and all(np.isfinite(card[3])))
        ok = ok and case_ok
        out[name] = {"logits_max_diff": logit_diff,
                     "stats_max_err_over_tol": stat_over,
                     "grad_max_diff": grad_diff, "losses_card": card[3],
                     "losses_cpu": host[3], "loss_max_diff": loss_diff,
                     "param_max_diff": param_max,
                     "param_frac_over_atol": param_frac,
                     "velocity_max_diff": vel_diff,
                     "buffer_max_err_over_tol": buf_over, "ok": case_ok}
    # ties: every element of each window is 0, as after a ReLU; the
    # gradient of each window goes to one of them
    grads = []
    for d in (dev, cpu):
        t = F.relu(torch.zeros((1, 1, 6, 6), device=d)).requires_grad_(True)
        F.max_pool2d(t, 3, 2, 1).sum().backward()
        grads.append(t.grad.cpu())
    ties_same = bool(torch.equal(grads[0], grads[1]))
    out["maxpool_ties"] = {"grad_card_equals_cpu": ties_same,
                           "grad_card": grads[0][0, 0].tolist()}
    out["ok"] = ok and ties_same and float(grads[1].sum()) == 9
    return out


def _reference_llama(dev, cfg):
    """A small f32 Llama on the card (the kernels) and on the CPU (the
    plain versions), from the same weights: greedy decode tokens identical
    and logits within ``REF_ATOL``; then the train step at B=2, S=256
    (flash-eligible: the grouped kernels in f32) under ``TRAIN_REF``.
    Returns (its readings, ok)."""
    from paddle_tpu_torch.models.nlp import LlamaForCausalLM

    state = {k: v.numpy() for k, v in
             LlamaForCausalLM(cfg, device="cpu", seed=11).state_dict()
             .items()}
    on_card = _drive_small(dev, state, cfg)
    on_cpu = _drive_small(torch.device("cpu"), state, cfg)
    diff = float((on_card - on_cpu).abs().max())
    same = bool(torch.equal(on_card.argmax(-1), on_cpu.argmax(-1)))
    ok = same and diff <= REF_ATOL

    rng = np.random.default_rng(12)
    tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (2, 256)))
                      for _ in range(2))
    train, train_ok = _train_agree(
        _train_small(dev, state, cfg, tokens, labels),
        _train_small(torch.device("cpu"), state, cfg, tokens, labels))
    hd = cfg.hidden_size // cfg.num_attention_heads
    return ({"config": {"hidden": cfg.hidden_size,
                        "heads": cfg.num_attention_heads,
                        "kv_heads": cfg.num_key_value_heads, "head_dim": hd,
                        "layers": cfg.num_hidden_layers},
             "max_logit_diff": diff, "tokens_identical": same,
             "atol": REF_ATOL, **train}, ok and train_ok)


# the training step's options in the reference phase: chunks of 48 over
# the vocabulary of 256 (the last chunk padded)
REF_CHUNK = 48


def _reference_llama_options(dev):
    """The training step's options, card against CPU, on a small f32 Llama
    (hidden 256, 4 / 2 heads, 2 layers, vocab 256) with tied embeddings
    and fused qkv and gate/up weights: logits with explicit (B, S)
    positions within ``REF_ATOL``; then 3 steps with ``remat="dots"``,
    the chunked CE (``REF_CHUNK``) and offloaded moments (pinned on the
    card) under ``TRAIN_REF``. Returns (its readings, ok)."""
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             load_numpy_state_dict)

    cfg = dataclasses.replace(
        LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=4,
                         kv_heads=2), tie_word_embeddings=True,
        fuse_attention_qkv=True, fuse_ffn_gate_up=True)
    state = {k: v.numpy() for k, v in
             LlamaForCausalLM(cfg, device="cpu", seed=13).state_dict()
             .items()}
    rng = np.random.default_rng(14)
    tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (2, 256)))
                      for _ in range(2))
    positions = torch.from_numpy(np.sort(rng.integers(0, 1024, (2, 256)),
                                         -1))
    logits = []
    for d in (dev, torch.device("cpu")):
        model = load_numpy_state_dict(LlamaForCausalLM(cfg, device=d), state)
        with torch.no_grad():
            logits.append(model(tokens.to(d), positions.to(d)).cpu())
    diff = float((logits[0] - logits[1]).abs().max())
    options = dict(remat="dots", chunked_vocab_ce=REF_CHUNK,
                   offload_moments=True)
    card = _train_small(dev, state, cfg, tokens, labels, **options)
    cpu = _train_small(torch.device("cpu"), state, cfg, tokens, labels,
                       **options)
    train, train_ok = _train_agree(card, cpu)
    ok = diff <= REF_ATOL and train_ok and card[3]
    return ({"config": "tiny, tied, fused qkv and gate/up", "options": {
        **options, "positions": "(B, S)"},
        "max_logit_diff_with_positions": diff, "atol": REF_ATOL,
        "moments_pinned": card[3], **train, "ok": ok}, ok)


def phase_reference(dev):
    from paddle_tpu_torch.models.nlp import LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"phase": "reference"}
    llama, ok = _reference_llama(dev, LlamaConfig.tiny(
        vocab=256, hidden=256, layers=2, heads=4, kv_heads=2))  # head_dim 64
    out.update(llama)
    # head_dim 256 and a kv group of 3, which does not divide the f32 row
    # tile: the paged kernel at D = 256 in decode and prefill, the grouped
    # f32 kernels one query head a tile
    wide, wide_ok = _reference_llama(dev, LlamaConfig.tiny(
        vocab=256, hidden=768, layers=2, heads=3, kv_heads=1))
    options, options_ok = _reference_llama_options(dev)
    enc = _reference_encoder(dev)
    bert = _reference_bert(dev)
    vision = _reference_vision(dev)
    out.update({"llama_d256_g3": {**wide, "ok": wide_ok},
                "llama_options": options, **enc, **bert, "vision": vision,
                "ok": ok and wide_ok and options_ok and enc["encoder_ok"]
                and bert["bert_ok"] and vision["ok"]})
    # the offloaded steps' pinned blocks go back to the host
    _release_pinned()
    emit(out)
    if not out["ok"]:
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
    by_instance = paged_attention.instance_launches
    for name in by_instance:
        by_instance[name] = 0
    t0 = time.perf_counter()
    res = serve(outer, layers, pools, prefill, decode, book, reqs,
                slots=slots, width=width, pad_to=C, log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    launched_by = dict(by_instance)

    pools = res["pools"]
    chunks = sum(-(-len(p) // C) for _, p, _ in reqs)
    want_launches = L * (chunks + res["steps"])
    # a decode step's layers take the split instance, a prefill chunk's
    # (bf16 over bf16 pools of 64 slots) the tensor cores'
    want_by = {"split": L * res["steps"], "mma": L * chunks, "rows": 0}
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
           "launches_by_instance": launched_by,
           "launches_by_instance_expected": want_by,
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
          and launched_by == want_by and out["step_logits_finite"] and diff <= STEP_ATOL)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("serve phase failed: " + json.dumps(out))
    if profile:
        # the paged kernel's instances, each its own family
        families = {"paged_split": ("paged_attention_split_kernel",),
                    "paged_mma": ("paged_prefill_mma",),
                    "paged_rows": ("paged_attention_kernel",),
                    "matmul": MATMUL_NAMES}
        emit({"phase": "profile", **_profile(
            lambda: decode(outer, layers, tok, pt, ln, pools), families)})
        # time to the first token: one 1024-token request (4 chunks of 256
        # through 32 layers) on the first slot's pages
        toks1 = toks[:1].to(dev)
        ln1 = torch.full((1,), toks1.shape[1], dtype=torch.int32,
                         device=dev)
        emit({"phase": "profile_prefill", "tokens": toks1.shape[1],
              "chunks": toks1.shape[1] // C, **_profile(
                  lambda: prefill(outer, layers, toks1, pt[:1], ln1, pools),
                  families)})
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


# --- phases 5-7: train Llama-3-8B, Llama-2-7B and Mistral-7B (8 layers) -----

def _mistral_7b():
    """Mistral-7B-v0.1 (its published config.json): Llama's layers with 8
    kv heads, inter 14336, vocab 32000, rope theta 10000 and a sliding
    window of 4096 tokens."""
    from paddle_tpu_torch.models.nlp import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=4096,
                       intermediate_size=14336, num_hidden_layers=32,
                       num_attention_heads=32, num_key_value_heads=8,
                       rope_theta=10000.0, sliding_window=4096)


def _llama2_7b():
    """Llama-2-7B: the defaults of ``LlamaConfig`` (32 / 32 heads, hidden
    4096, inter 11008, vocab 32000, rope theta 10000)."""
    from paddle_tpu_torch.models.nlp import LlamaConfig

    return LlamaConfig()


def _llama3_8b():
    from paddle_tpu_torch.models.nlp import LlamaConfig

    return LlamaConfig.llama3_8b()


# phase -> (model, its config, batch, sequence, the attention kernels of
# its path, the cut). Each keeps 8 of its 32 layers at full width: params,
# grads and f32 AdamW moments (~12 B a parameter) of all 32 exceed one
# 80 GB card before any activation.
TRAIN_CELLS = {
    "train": ("llama3_8b", _llama3_8b, 2, 4096, "gqa",
              "8 of 32 decoder layers, full width: params, grads and f32 "
              "AdamW moments of 32 layers (~96 GB) exceed one 80 GB card"),
    "train_mha": ("llama2_7b", _llama2_7b, 2, 4096, "mha",
                  "8 of 32 decoder layers, full width: params, grads and "
                  "f32 AdamW moments of 32 layers (6.74 B params, ~81 GB) "
                  "exceed one 80 GB card"),
    "train_window": ("mistral_7b", _mistral_7b, 1, 8192, "splash",
                     "8 of 32 decoder layers, full width: params, grads "
                     "and f32 AdamW moments of 32 layers (7.24 B params, "
                     "~87 GB) exceed one 80 GB card"),
}
ATTENTION_KINDS = ("gqa", "mha", "splash")


def _counters():
    """{kind: the entry point holding its launch counts}, the CE's, and
    {name: the norm or paged entry point holding its count}."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention_gqa")
    fm = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    sa = importlib.import_module("paddle_tpu_torch.ops.splash_attention")
    ce = importlib.import_module("paddle_tpu_torch.ops.fused_ce")
    lnm = importlib.import_module("paddle_tpu_torch.ops.layer_norm")
    dl = importlib.import_module("paddle_tpu_torch.ops.dropout_ln")
    pa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
    return ({"gqa": fa.grouped_flash_attention, "mha": fm.flash_attention,
             "splash": sa.splash_attention}, ce.softmax_cross_entropy,
            {"dropout_add_ln": dl.fused_dropout_add_layer_norm,
             "layer_norm": lnm.fused_layer_norm,
             "rms_norm": lnm.fused_rms_norm,
             "paged": pa.paged_attention})


def _train_counts():
    """The launch count of every kernel entry point a train phase could
    reach."""
    attn, c, others = _counters()
    out = {f"{k}_{part}": getattr(attn[k], f"launches_{part}")
           for k in ATTENTION_KINDS for part in ("fwd", "dq", "dkv")}
    out.update({"ce_fwd": c.launches_fwd, "ce_bwd": c.launches_bwd})
    out.update({k: owner.launches for k, owner in others.items()})
    return out


def _zero_train_counts():
    attn, c, others = _counters()
    for owner in attn.values():
        owner.launches_fwd = owner.launches_dq = owner.launches_dkv = 0
    c.launches_fwd = c.launches_bwd = 0
    for owner in others.values():
        owner.launches = 0


def _live_pairs_per_head(S, window):
    """Causal (query, key) pairs of one head, within ``window`` if set."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def _step_flops(cfg, B, S):
    """6 x (matmul params incl. lm_head) x tokens + 12 x D x live pairs x
    layers (attention: 4 forward, 8 backward; the backward kernels'
    recomputation of the scores is not counted). Live pairs are the
    causal ones, within the sliding window where there is one."""
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd = H // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * hd
    L = cfg.num_hidden_layers
    matmul_params = L * (2 * H * H + 2 * H * kv + 3 * H * F) + H * V
    window = cfg.sliding_window if cfg.sliding_window and \
        cfg.sliding_window < S else None
    pairs = B * cfg.num_attention_heads * _live_pairs_per_head(S, window)
    return 6 * matmul_params * B * S + 12 * hd * pairs * L, matmul_params


def _plain_swaps(kind):
    """(module, attribute, plain version) for the attention kernels of
    ``kind`` and the CE kernels."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention_gqa")
    fm = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    sa = importlib.import_module("paddle_tpu_torch.ops.splash_attention")
    ce = importlib.import_module("paddle_tpu_torch.ops.fused_ce")
    attn = {"gqa": [(fa, "gqa_fwd", fa._gqa_fwd_plain),
                    (fa, "gqa_bwd", fa._gqa_bwd_plain)],
            "mha": [(fm, "mha_fwd", fa._gqa_fwd_plain),
                    (fm, "mha_bwd", fa._gqa_bwd_plain)],
            "splash": [(sa, "splash_fwd", sa._splash_fwd_plain),
                       (sa, "splash_bwd", sa._splash_bwd_plain)]}[kind]
    return attn + [(ce, "ce_fwd", ce._ce_fwd_plain),
                   (ce, "ce_bwd", ce._ce_bwd_plain)]


@contextlib.contextmanager
def _swapped(swaps, swap=True):
    """Within it, each (module, attribute, plain version) of ``swaps`` has
    its plain version in place of the kernel (module attributes swapped,
    as the serve phase swaps ``paged_attention``); with ``swap`` False,
    the kernels."""
    kept = [getattr(m, name) for m, name, _ in swaps]
    if swap:
        for m, name, plain in swaps:
            setattr(m, name, plain)
    try:
        yield
    finally:
        for (m, name, _), fn in zip(swaps, kept):
            setattr(m, name, fn)


def _plain_versions(kind, swap=True):
    """``_swapped`` over the attention kernels of ``kind`` and the CE
    kernels."""
    return _swapped(_plain_swaps(kind), swap)


def _grads_with(swap, kind, cfg, params, tokens, labels, remat=False,
                chunked=None):
    """Loss and gradients of one forward+backward (``remat``, and the
    chunked CE with ``chunked``); ``swap`` runs the plain versions in
    place of the kernels."""
    from paddle_tpu_torch.models.nlp import param_views
    from paddle_tpu_torch.models.nlp.llama_functional import loss_fn

    with _plain_versions(kind, swap):
        outer, layers = param_views(params, cfg.num_hidden_layers)
        loss = loss_fn(cfg, outer, layers, tokens, labels, remat, chunked)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
    return float(loss.detach()), grads


def phase_train(dev, phase="train", profile=False, plain_curves=False):
    from paddle_tpu_torch.examples.train_llama_compiled import train
    from paddle_tpu_torch.models.nlp import LlamaForCausalLM

    model_name, make_cfg, B, S, kind, cut = TRAIN_CELLS[phase]
    cfg = dataclasses.replace(make_cfg(), num_hidden_layers=TRAIN_LAYERS)
    steps, lr, seed = 5, 1e-3, 0

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
    loss_k, grads_k = _grads_with(False, kind, cfg, params, tokens, labels)
    loss_p, grads_p = _grads_with(True, kind, cfg, params, tokens, labels)
    rel = {}
    for k, a, b in zip(params, grads_k, grads_p):
        rel[k] = float((a.float() - b.float()).norm() / b.float().norm())
    del grads_k, grads_p
    # the forward and backward alone (no optimizer), warm, host clock
    t0 = time.perf_counter()
    _grads_with(False, kind, cfg, params, tokens, labels)
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
    want = {k: 0 for k in counts}
    want.update({f"{kind}_{part}": TRAIN_LAYERS * steps
                 for part in ("fwd", "dq", "dkv")})
    want.update({"ce_fwd": steps, "ce_bwd": steps})
    losses = res["losses"]
    step_s = statistics.median(res["step_s"])
    flops, matmul_params = _step_flops(cfg, B, S)
    out = {"phase": phase, "model": model_name,
           "layers": TRAIN_LAYERS, "layers_full": 32, "cut": cut,
           "attention": kind, "sliding_window": cfg.sliding_window,
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
                          "causal pairs of a head within the window",
           "launches": counts, "launches_expected": want,
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_diff": abs(loss_k - loss_p),
           "loss_atol": TRAIN_LOSS_ATOL[phase],
           "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
           "grad_rel_err_median": statistics.median(rel.values()),
           "grad_rel_limit": TRAIN_GRAD_REL,
           "grad_rel_err": rel}
    ok = (counts == want and all(np.isfinite(losses))
          and losses[-1] < losses[0]
          and out["loss_diff"] <= TRAIN_LOSS_ATOL[phase]
          and rel[worst] <= TRAIN_GRAD_REL)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError(f"{phase} phase failed: " + json.dumps(
            {k: v for k, v in out.items() if k != "grad_rel_err"}))
    if profile:
        step, params, opt = res["step"], res["params"], res["opt_state"]

        def one_step():
            float(step(params, opt, res["tokens"], res["labels"])[2])

        emit({"phase": f"profile_{phase}", **_profile(
            one_step, {"flash_attention": ("causalwalk",),
                       "splash_attention": ("splashwalk",),
                       "fused_ce": ("ce_fwd", "ce_bwd"),
                       "matmul": MATMUL_NAMES}, n=3)})
        del step, params, opt, one_step
    del res
    torch.cuda.empty_cache()
    if plain_curves:
        # the same 5 steps from the same weights and batch with the plain
        # attention and CE versions: the curve the kernels should follow
        with _plain_versions(kind):
            plain = train(cfg, B, S, steps, lr=lr, device=dev, seed=seed,
                          remat=False, log=None)["losses"]
        torch.cuda.empty_cache()
        out["losses_plain"] = plain
        emit({"phase": f"plain_curves_{phase}", "losses_kernels": losses,
              "losses_plain": plain,
              "max_abs_diff": max(abs(a - b) for a, b in zip(losses, plain))})
    return out


# --- phases 8-9: Llama-3-8B at full depth with its moments in pinned host
# memory (train_full); a tied Llama-3.2-3B at S=8192 (train_long) ----------

def _llama32_3b_long():
    from paddle_tpu_torch.examples.train_llama_long_context import \
        llama32_3b_long

    return llama32_3b_long()


# phase -> (model, its config, B, S, lr, remat, offload_moments, chunked
# CE): train_full is Llama-3-8B at all 32 layers with remat=True and AdamW's
# f32 moments (64.2 GB) in pinned host memory; train_long is Llama-3.2-3B's
# widths (the long-context example's config: tied, fused qkv and gate/up,
# plain rope) at all 28 layers with remat="dots" and the chunked CE in
# chunks of 16384 (8 chunks, the last padded). Both run the grouped flash
# kernels (G = 4 and G = 3); train_full the fused CE kernels too.
DEPTH_CELLS = {
    "train_full": ("llama3_8b", _llama3_8b, 2, 4096, 1e-3, True, True, None),
    "train_long": ("llama3_2_3b", _llama32_3b_long, 1, 8192, 3e-4, "dots",
                   False, 16384),
}
DEPTH_STEPS, DEPTH_WARMUP = 5, 1
# the phases' checks run at full width and this depth
CHECK_LAYERS = 2
# host memory left free beside the pinned moments: the process, the
# checkout and the rest of the machine
HOST_MARGIN = 8 * 2 ** 30
# 2-layer bf16 forward+backward at full width, kernels vs plain versions,
# identical weights: bf16 roundings in 2 layers. Readings |Δloss| 4.10e-5
# (train_full, of 12.60) and 4.86e-5 (train_long, of 12.38); relative
# gradient errors 0.0124 / 0.0114 median, 0.0199 / 0.0123 worst, held to
# TRAIN_GRAD_REL. The loss limits are about twice the readings (one H100,
# PERF.md §2).
DEPTH_LOSS_ATOL = {"train_full": 1e-4, "train_long": 1e-4}
# chunked against dense f32 CE on train_long's final hidden states and
# embedding: the loss is the same f32 sums in another order (reading
# 3.1e-7 relative on one H100, the limit 2e-6 about six times that); dx
# and dw round the chunk's (p - onehot) / N to bf16 before its products
# and the results to bf16 once, so ||chunked - dense|| / ||dense|| sits
# near bf16's relative rounding: readings 1.66e-3 for both, the limit
# 2^-8 (3.9e-3) about twice that
CHUNKED_TOL = dict(loss_rel=2e-6, grad_rel=2 ** -8)


def _param_count(cfg):
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
    layer = 2 * H * H + 2 * H * kv + 3 * H * F + 2 * H
    head = 0 if cfg.tie_word_embeddings else H * V
    return cfg.num_hidden_layers * layer + V * H + H + head


def _pinned_block(nbytes):
    """The bytes the pinned host allocator takes for a block: the next
    power of two."""
    return 1 << (nbytes - 1).bit_length()


def _host_memory():
    """MemTotal and MemAvailable of /proc/meminfo, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":")
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(value.split()[0]) * 1024
    return out


def _offload_depth(cfg, available):
    """The deepest cut of ``cfg`` whose two f32 moment blocks the host can
    pin with ``HOST_MARGIN`` to spare (all its layers where it can)."""
    for layers in range(cfg.num_hidden_layers, 0, -1):
        n = _param_count(dataclasses.replace(cfg, num_hidden_layers=layers))
        if 2 * _pinned_block(4 * n) + HOST_MARGIN <= available:
            return layers
    raise RuntimeError(f"the host cannot pin the moments of one layer "
                       f"({available / 2 ** 30:.1f} GiB available)")


def _batch(cfg, B, S, seed, dev):
    """The batch ``train`` makes from ``seed``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
            .to(dev) for _ in range(2)]


def _rel_errs(params, got, want):
    return {k: float((a.float() - b.float()).norm() / b.float().norm())
            for k, a, b in zip(params, got, want)}


def _chunked_vs_dense(cfg, params, tokens, labels, chunk):
    """``chunked_causal_lm_loss`` against the dense f32 log-softmax loss on
    the final hidden states and the embedding of ``params``: loss, dx and
    dw."""
    from paddle_tpu_torch.models.nlp import param_views
    from paddle_tpu_torch.models.nlp.llama_functional import hidden_states
    from paddle_tpu_torch.ops.chunked_ce import chunked_causal_lm_loss

    outer, layers = param_views(params, cfg.num_hidden_layers)
    with torch.no_grad():
        h = hidden_states(cfg, outer, layers, tokens, remat=False)
    emb = params["model.embed_tokens.weight"].detach()
    x, w = h.clone().requires_grad_(), emb.clone().requires_grad_()
    loss_c = chunked_causal_lm_loss(x, w, labels, chunk)
    dx_c, dw_c = torch.autograd.grad(loss_c, (x, w))
    # dense: the (N, V) f32 logits of the same bf16 values (f32 products
    # of bf16 values are exact; TF32 is off, PyTorch's default and the
    # reference phase's setting), log-softmax, mean NLL
    xf, wf = h.float().requires_grad_(), emb.float().requires_grad_()
    logp = torch.log_softmax(xf.reshape(-1, xf.shape[-1]) @ wf.T, -1)
    loss_d = -logp.gather(1, labels.reshape(-1, 1)).mean()
    dx_d, dw_d = torch.autograd.grad(loss_d, (xf, wf))
    del logp
    out = {"chunk": chunk, "chunks": -(-cfg.vocab_size // chunk),
           "loss_chunked": loss_c.item(), "loss_dense": loss_d.item(),
           "loss_rel_err": abs(loss_c.item() - loss_d.item())
           / abs(loss_d.item())}
    for name, a, b in (("dx", dx_c, dx_d), ("dw", dw_c, dw_d)):
        out[f"{name}_rel_err"] = float((a.float() - b).norm() / b.norm())
        out[f"{name}_max_abs_err"] = float((a.float() - b).abs().max())
    out["tol"] = CHUNKED_TOL
    out["ok"] = (out["loss_rel_err"] <= CHUNKED_TOL["loss_rel"]
                 and out["dx_rel_err"] <= CHUNKED_TOL["grad_rel"]
                 and out["dw_rel_err"] <= CHUNKED_TOL["grad_rel"])
    return out


def _offload_vs_device(cfg, B, S, lr, remat, chunked, dev):
    """3 steps of the factory with moments in pinned host memory and 3 with
    moments on the card, from the same weights and batch: whether the
    parameters and the moments are the same bits, and every moment is
    pinned."""
    from paddle_tpu_torch.models.nlp import (LlamaForCausalLM,
                                             llama_train_step_factory)

    tokens, labels = _batch(cfg, B, S, 0, dev)
    runs = {}
    for offload in (False, True):
        model = LlamaForCausalLM(cfg, device=dev, seed=0)
        params, opt, step = llama_train_step_factory(
            model, learning_rate=lr, remat=remat, device=dev,
            offload_moments=offload, chunked_vocab_ce=chunked)
        losses = [float(step(params, opt, tokens, labels)[2])
                  for _ in range(3)]
        torch.cuda.synchronize()
        runs[offload] = (losses, params, opt)
        del model, step
    (losses, params, opt), (o_losses, o_params, o_opt) = runs[False], \
        runs[True]
    params_equal = all(torch.equal(params[k], o_params[k]) for k in params)
    moments_equal = all(torch.equal(opt[n][k].cpu(), o_opt[n][k])
                        for n in ("m", "v") for k in params)
    pinned = all(m.is_pinned() for n in ("m", "v")
                 for m in o_opt[n].values())
    out = {"steps": 3, "losses_device": losses, "losses_offload": o_losses,
           "params_bit_equal": params_equal,
           "moments_bit_equal": moments_equal, "moments_pinned": pinned,
           "ok": params_equal and moments_equal and pinned
           and losses == o_losses}
    del runs, params, opt, o_params, o_opt
    torch.cuda.empty_cache()
    _release_pinned()
    return out


def _depth_checks(dev, phase, cfg, B, S, lr, remat, offload, chunked):
    """The phase's checks at full width and ``CHECK_LAYERS`` layers: the
    kernels against their plain versions (one forward+backward each, the
    phase's options), the three remat modes (the same bits), the chunked
    CE against the dense one (with the chunked CE), and offloaded moments
    against moments on the card (with offload)."""
    from paddle_tpu_torch.models.nlp import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    params = {k: p.requires_grad_() for k, p in model.named_parameters()}
    tokens, labels = _batch(cfg, B, S, 0, dev)
    loss_k, grads_k = _grads_with(False, "gqa", cfg, params, tokens, labels,
                                  remat, chunked)
    loss_p, grads_p = _grads_with(True, "gqa", cfg, params, tokens, labels,
                                  remat, chunked)
    rel = _rel_errs(params, grads_k, grads_p)
    del grads_p
    worst = max(rel, key=rel.get)
    out = {"layers": cfg.num_hidden_layers, "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_diff": abs(loss_k - loss_p),
           "loss_atol": DEPTH_LOSS_ATOL[phase],
           "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
           "grad_rel_err_median": statistics.median(rel.values()),
           "grad_rel_limit": TRAIN_GRAD_REL}
    ok = (out["loss_diff"] <= DEPTH_LOSS_ATOL[phase]
          and rel[worst] <= TRAIN_GRAD_REL)
    # the remat modes against the phase's own: the same operations on the
    # same values, so the same bits
    modes = {}
    for mode in (False, True, "dots"):
        loss_m, grads_m = _grads_with(False, "gqa", cfg, params, tokens,
                                      labels, mode, chunked)
        modes[str(mode)] = {
            "loss": loss_m,
            "max_grad_diff": max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(grads_m, grads_k)),
            "bit_equal": loss_m == loss_k and all(
                torch.equal(a, b) for a, b in zip(grads_m, grads_k))}
        del grads_m
    del grads_k
    out["remat_modes"] = modes
    ok = ok and all(m["bit_equal"] for m in modes.values())
    if chunked:
        out["chunked_vs_dense"] = _chunked_vs_dense(cfg, params, tokens,
                                                    labels, chunked)
        ok = ok and out["chunked_vs_dense"]["ok"]
    del model, params
    torch.cuda.empty_cache()
    if offload:
        out["offload_vs_device"] = _offload_vs_device(cfg, B, S, lr, remat,
                                                      chunked, dev)
        ok = ok and out["offload_vs_device"]["ok"]
    out["ok"] = ok
    return out


def _pcie_ms(opt, dev):
    """Every moment host -> card, then card -> host, each direction alone
    on the current stream, then both at once on two streams (CUDA
    events): the copies of an offloaded update without the update."""
    moments = [t for n in ("m", "v") for t in opt[n].values()]
    largest = max(t.numel() for t in moments)
    buf = torch.empty(largest, dtype=moments[0].dtype, device=dev)
    src = torch.empty(largest, dtype=moments[0].dtype, device=dev)
    back = torch.empty(largest, dtype=moments[0].dtype, pin_memory=True)

    def h2d(t):
        buf[:t.numel()].copy_(t.reshape(-1), non_blocking=True)

    def d2h(t):
        back[:t.numel()].copy_(src[:t.numel()], non_blocking=True)

    def timed(run):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def both():
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for t in moments:
                d2h(t)
        for t in moments:
            h2d(t)
        main.wait_stream(side)

    out = {"bytes": sum(t.numel() * t.element_size() for t in moments)}
    for name, run in (("h2d", lambda: [h2d(t) for t in moments]),
                      ("d2h", lambda: [d2h(t) for t in moments]),
                      ("both", both)):
        out[f"{name}_ms"] = timed(run)
        out[f"{name}_gb_s"] = (2 if name == "both" else 1) * out["bytes"] \
            / out[f"{name}_ms"] / 1e6
    del buf, src, back
    return out


def _release_pinned():
    """Give the host allocator's cached pinned blocks back to the host."""
    gc.collect()
    torch._C._host_emptyCache()


def _time_parts(res, cfg, remat, chunked):
    """Two more steps on the trained model, host clock, each up to a
    synchronise: its forward and backward alone (the gradients dropped),
    then one whole step of the factory's own ``train_step``. Returns
    (fwd_bwd_ms, update_ms), the update being the whole step less the
    forward and backward."""
    from paddle_tpu_torch.models.nlp import param_views
    from paddle_tpu_torch.models.nlp.llama_functional import loss_fn

    params = res["params"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outer, layers = param_views(params, cfg.num_hidden_layers)
    loss = loss_fn(cfg, outer, layers, res["tokens"], res["labels"], remat,
                   chunked)
    grads = torch.autograd.grad(loss, list(params.values()))
    del loss, grads
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res["params"], res["opt_state"], _ = res["step"](
        params, res["opt_state"], res["tokens"], res["labels"])
    torch.cuda.synchronize()
    fwd_bwd, step = t1 - t0, time.perf_counter() - t1
    return 1e3 * fwd_bwd, 1e3 * (step - fwd_bwd)


def phase_train_depth(dev, phase):
    from paddle_tpu_torch.examples.train_llama_compiled import train

    model_name, make_cfg, B, S, lr, remat, offload, chunked = \
        DEPTH_CELLS[phase]
    full = make_cfg()
    host = _host_memory()
    layers, cut = full.num_hidden_layers, None
    if offload:
        layers = _offload_depth(full, host["MemAvailable"])
        if layers < full.num_hidden_layers:
            cut = (f"{layers} of {full.num_hidden_layers} layers: the host "
                   f"has {host['MemAvailable'] / 2 ** 30:.1f} GiB "
                   f"available, and the moments of every layer take "
                   f"{2 * _pinned_block(4 * _param_count(full)) / 2 ** 30:.0f}"
                   f" GiB of pinned blocks")
    cfg = dataclasses.replace(full, num_hidden_layers=layers)
    checks = _depth_checks(dev, phase, dataclasses.replace(
        full, num_hidden_layers=CHECK_LAYERS), B, S, lr, remat, offload,
        chunked)

    # the main path: launch counts from 0, a warm-up step and 5 timed ones
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    t0 = time.perf_counter()
    res = train(cfg, B, S, DEPTH_STEPS, lr=lr, device=dev, seed=0,
                remat=remat, log=None, offload_moments=offload,
                chunked_vocab_ce=chunked, warmup=DEPTH_WARMUP)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = DEPTH_STEPS + DEPTH_WARMUP
    fwd_per_step = (2 if remat else 1) * layers
    want = {k: 0 for k in counts}
    want.update({"gqa_fwd": fwd_per_step * steps, "gqa_dq": layers * steps,
                 "gqa_dkv": layers * steps})
    if not chunked:
        want.update({"ce_fwd": steps, "ce_bwd": steps})
    opt = res["opt_state"]
    moment_bytes = sum(t.numel() * t.element_size() for n in ("m", "v")
                       for t in opt[n].values())
    pinned = {"moment_bytes": moment_bytes,
              "where": "pinned host memory" if offload else "the card",
              "all_pinned": offload and all(
                  t.is_pinned() for n in ("m", "v") for t in opt[n].values())}
    if offload:
        pinned["host_allocator_bytes"] = \
            torch.cuda.memory.host_memory_stats()["allocated_bytes.current"]
    fwd_bwd_ms, update_ms = _time_parts(res, cfg, remat, chunked)
    pcie = _pcie_ms(opt, dev) if offload else None
    losses = res["losses"]
    step_s = statistics.median(res["step_s"])
    flops, matmul_params = _step_flops(cfg, B, S)
    out = {"phase": phase, "model": model_name, "layers": layers,
           "layers_full": full.num_hidden_layers, "cut": cut,
           "params": _param_count(cfg), "hidden": cfg.hidden_size,
           "heads": cfg.num_attention_heads,
           "kv_heads": cfg.num_key_value_heads, "vocab": cfg.vocab_size,
           "tied": cfg.tie_word_embeddings,
           "fused_qkv": cfg.fuse_attention_qkv,
           "fused_gate_up": cfg.fuse_ffn_gate_up,
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "B": B, "S": S, "steps": DEPTH_STEPS,
           "warmup_steps": DEPTH_WARMUP, "lr": lr, "remat": remat,
           "offload_moments": offload, "chunked_vocab_ce": chunked,
           "host_memory_gib": {k: v / 2 ** 30 for k, v in host.items()},
           "losses": losses, "warmup_losses": res["warmup_losses"],
           "step_ms_median": 1e3 * step_s,
           "step_ms": [1e3 * t for t in res["step_s"]],
           "fwd_bwd_ms": fwd_bwd_ms, "update_ms": update_ms,
           "pcie": pcie, "main_path_s": run_s,
           "tokens_per_s": B * S / step_s, "peak_mem_gb": peak_gb,
           "moments": pinned, "step_flops": flops,
           "matmul_params": matmul_params,
           "mfu": flops / step_s / BF16_FLOP_PER_S,
           "mfu_formula": "(6*matmul_params*tokens + 12*head_dim*pairs*"
                          "layers) / step_s / 989e12 (model FLOPs: the "
                          "remat recomputation and the chunked CE's second "
                          "head product are not counted)",
           "launches": counts, "launches_expected": want,
           "launches_per_step": {"gqa_fwd": fwd_per_step, "gqa_dq": layers,
                                 "gqa_dkv": layers,
                                 "ce": 0 if chunked else 1},
           "checks": checks}
    ok = (counts == want and checks["ok"] and all(np.isfinite(losses))
          and losses[-1] < losses[0] and (not offload or pinned["all_pinned"]))
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError(f"{phase} phase failed: " + json.dumps(out))
    del res, opt
    torch.cuda.empty_cache()
    _release_pinned()
    emit({"phase": f"{phase}_release",
          "host_memory_gib": {k: v / 2 ** 30
                              for k, v in _host_memory().items()},
          "host_allocator": torch.cuda.memory.host_memory_stats()})
    return out


# --- phase 10: train the fused encoder (incubate.nn) at BERT-base width ---

def _encoder(dev, layers, d_model, nhead, dim_feedforward, dropout_rate,
             generator, dtype):
    """A stack of post-LN ``FusedTransformerEncoderLayer``s (GELU) made on
    ``dev`` from ``generator`` and cast to ``dtype``."""
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer

    return torch.nn.ModuleList([
        FusedTransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                     dropout_rate=dropout_rate,
                                     activation="gelu", device=dev,
                                     generator=generator)
        for _ in range(layers)]).to(dtype)


def _encoder_loss(stack, x, tgt):
    h = x
    for layer in stack:
        h = layer(h)
    return torch.square(h.float() - tgt.float()).mean()


def _encoder_step(stack, opt, x, tgt, lr):
    """One training step: the MSE loss, its gradients and the port's
    ``apply_adamw`` (f32 moments; the Llama train-step factory's betas,
    eps and weight decay) of every parameter that has a gradient
    (``ln_pre`` of a post-LN layer has none). Returns the loss."""
    from paddle_tpu_torch.models.nlp.train_utils import apply_adamw

    params = dict(stack.named_parameters())
    loss = _encoder_loss(stack, x, tgt)
    grads = list(torch.autograd.grad(loss, list(params.values()),
                                     allow_unused=True))
    apply_adamw(params, grads, opt, lr, 0.9, 0.95, 1e-8, 0.01)
    return loss.detach()


def _encoder_train(stack, x, tgt, steps, lr):
    """``steps`` training steps on one batch: (losses, host-clock seconds
    of each step up to its loss on the host, the optimizer state)."""
    from paddle_tpu_torch.models.nlp import make_adamw_state

    opt = make_adamw_state(dict(stack.named_parameters()))
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(_encoder_step(stack, opt, x, tgt, lr)))
        step_s.append(time.perf_counter() - t0)
    return losses, step_s, opt


def _mha_swaps():
    """(module, attribute, plain version) for the multi-head flash
    kernels."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention_gqa")
    fm = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    return [(fm, "mha_fwd", fa._gqa_fwd_plain),
            (fm, "mha_bwd", fa._gqa_bwd_plain)]


def _encoder_swaps():
    """The same for the kernels of the encoder's path: the multi-head
    flash kernels and the dropout-add-LN kernel."""
    dl = importlib.import_module("paddle_tpu_torch.ops.dropout_ln")
    return _mha_swaps() + [(dl, "dropout_add_ln_fwd", dl._forward_plain)]


def _encoder_grads(swap, stack, x, tgt, gen, seed):
    """Loss and gradients (None for an unused parameter) of one forward
    and backward, the generator reseeded first so both calls draw the
    same dropout; ``swap`` runs the plain versions in place of the
    kernels."""
    with _swapped(_encoder_swaps(), swap):
        gen.manual_seed(seed)
        loss = _encoder_loss(stack, x, tgt)
        grads = torch.autograd.grad(loss, list(stack.parameters()),
                                    allow_unused=True)
        torch.cuda.synchronize()
    return float(loss.detach()), grads


def phase_train_encoder(dev, profile=False):
    from paddle_tpu_torch.core import Generator

    e = ENCODER
    L, d, heads, B, S = e["layers"], e["d_model"], e["nhead"], e["B"], e["S"]
    steps, lr, seed = e["steps"], e["lr"], e["seed"]
    gen = Generator(seed)               # weights, then every dropout draw
    stack = _encoder(dev, L, d, heads, e["dim_feedforward"],
                     e["dropout_rate"], gen, torch.bfloat16)
    stack.train()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((B, S, d), generator=g, device=dev).to(torch.bfloat16)
    tgt = torch.randn((B, S, d), generator=g, device=dev).to(torch.bfloat16)

    # kernels against plain versions: one forward+backward each, identical
    # weights, batch and dropout draws
    loss_k, grads_k = _encoder_grads(False, stack, x, tgt, gen, seed + 2)
    loss_p, grads_p = _encoder_grads(True, stack, x, tgt, gen, seed + 2)
    rel, noise = {}, {}
    for (k, _), a, b in zip(stack.named_parameters(), grads_k, grads_p):
        if b is not None:
            (noise if k.endswith(NOISE_GRAD_PARAMS) else rel)[k] = float(
                (a.float() - b.float()).norm() / b.float().norm())
    del grads_k, grads_p
    worst = max(rel, key=rel.get)
    t0 = time.perf_counter()
    _encoder_grads(False, stack, x, tgt, gen, seed + 2)
    fwd_bwd_s = time.perf_counter() - t0

    # the main path: launch counts from 0, the training steps
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    losses, step_s, opt = _encoder_train(stack, x, tgt, steps, lr)
    torch.cuda.synchronize()
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: 0 for k in counts}
    want.update({"mha_fwd": L * steps, "mha_dq": L * steps,
                 "mha_dkv": L * steps, "dropout_add_ln": 2 * L * steps})
    step = statistics.median(step_s)
    hd = d // heads
    matmul_params = L * (4 * d * d + 2 * d * e["dim_feedforward"])
    pairs = B * heads * S * S                    # non-causal
    flops = 6 * matmul_params * B * S + 12 * hd * pairs * L
    out = {"phase": "train_encoder", "model": "bert_base_width_encoder",
           "layer": "FusedTransformerEncoderLayer(768, 12, 3072, "
                    "dropout_rate=0.1, activation='gelu'), post-LN",
           "layers": L, "dtype": "bfloat16", "B": B, "S": S,
           "steps": steps, "lr": lr, "loss": "MSE against N(0, 1)",
           "losses": losses, "step_ms_median": 1e3 * step,
           "step_ms": [1e3 * t for t in step_s],
           "fwd_bwd_ms": 1e3 * fwd_bwd_s, "tokens_per_s": B * S / step,
           "peak_mem_gb": peak_gb, "step_flops": flops,
           "matmul_params": matmul_params,
           "mfu": flops / step / BF16_FLOP_PER_S,
           "mfu_formula": "(6*matmul_params*tokens + 12*head_dim*pairs*"
                          "layers) / step_s / 989e12; pairs = B*heads*S^2 "
                          "(non-causal)",
           "launches": counts, "launches_expected": want,
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_diff": abs(loss_k - loss_p), "loss_atol": ENC_LOSS_ATOL,
           "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
           "grad_rel_err_median": statistics.median(rel.values()),
           "grad_rel_limit": ENC_GRAD_REL, "grad_rel_err": rel,
           "noise_grad_rel_err_max": max(noise.values())}
    ok = (counts == want and all(np.isfinite(losses))
          and losses[-1] < losses[0] and out["loss_diff"] <= ENC_LOSS_ATOL
          and rel[worst] <= ENC_GRAD_REL)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("train_encoder phase failed: " + json.dumps(
            {k: v for k, v in out.items() if k != "grad_rel_err"}))
    if profile:
        emit({"phase": "profile_train_encoder", **_profile(
            lambda: float(_encoder_step(stack, opt, x, tgt, lr)),
            {"flash_attention": ("causalwalk",),
             "dropout_add_ln": ("rows_kernel",),
             "matmul": MATMUL_NAMES}, n=3)})
    del stack, opt
    torch.cuda.empty_cache()
    return out


# --- phase 11: BERT-base pretraining (models/nlp/bert.py) ------------------

def _bert_batch(vocab, B, S, seed, dev):
    """Seeded pretraining data: ids uniform over the vocabulary, token
    types 0 on each row's first half and 1 on its second, MLM labels a
    vocabulary id on ``BERT["mlm_share"]`` of the positions and -100
    elsewhere, NSP labels uniform over {0, 1}."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, vocab, (B, S), generator=g, device=dev)
    types = (torch.arange(S, device=dev) >= S // 2).long().expand(B, S)
    picked = torch.rand((B, S), generator=g, device=dev) < BERT["mlm_share"]
    mlm = torch.where(picked, torch.randint(0, vocab, (B, S), generator=g,
                                            device=dev), -100)
    nsp = torch.randint(0, 2, (B,), generator=g, device=dev)
    return [ids, types.contiguous(), mlm, nsp]


def _bert_grads(swap, model, batch, gen, seed):
    """Loss and gradients of one forward and backward of the pretraining
    loss, the generator reseeded first so both calls draw the same
    dropout; ``swap`` runs the multi-head flash kernels' plain versions."""
    from paddle_tpu_torch.models.nlp.bert import pretrain_loss

    with _swapped(_mha_swaps(), swap):
        gen.manual_seed(seed)
        loss = pretrain_loss(model, *batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
    return float(loss.detach()), grads


def phase_train_bert(dev, profile=False):
    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.models.nlp import (BertConfig, BertForPretraining,
                                             bert_pretrain_step_factory)

    b = BERT
    B, S, steps, seed = b["B"], b["S"], b["steps"], b["seed"]
    cfg = BertConfig()
    L, d, heads = (cfg.num_hidden_layers, cfg.hidden_size,
                   cfg.num_attention_heads)
    gen = Generator(seed)               # weights, then every dropout draw
    model = BertForPretraining(cfg, device=dev, generator=gen) \
        .to(torch.bfloat16)
    model.train()
    batch = _bert_batch(cfg.vocab_size, B, S, seed + 1, dev)
    params, opt, step = bert_pretrain_step_factory(model, None, device=dev)

    # kernels against plain versions: one forward+backward each, identical
    # weights, batch and dropout draws
    loss_k, grads_k = _bert_grads(False, model, batch, gen, seed + 2)
    loss_p, grads_p = _bert_grads(True, model, batch, gen, seed + 2)
    rel, noise = {}, {}
    for k, a, g in zip(params, grads_k, grads_p):
        (noise if k.endswith(NOISE_GRAD_PARAMS) else rel)[k] = float(
            (a.float() - g.float()).norm() / g.float().norm())
    del grads_k, grads_p
    worst = max(rel, key=rel.get)
    t0 = time.perf_counter()
    _bert_grads(False, model, batch, gen, seed + 2)
    fwd_bwd_s = time.perf_counter() - t0

    # the main path: a warm-up step, then launch counts from 0 and the
    # timed steps, each up to its loss on the host
    warmup = [float(step(params, opt, *batch)[2])
              for _ in range(b["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(params, opt, *batch)[2]))
        step_s.append(time.perf_counter() - t0)
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: 0 for k in counts}
    want.update({"mha_fwd": L * steps, "mha_dq": L * steps,
                 "mha_dkv": L * steps})
    step_med = statistics.median(step_s)
    F, V = cfg.intermediate_size, cfg.vocab_size
    matmul_params = L * (4 * d * d + 2 * d * F) + d * d + d * V
    pairs = B * heads * S * S                    # non-causal
    flops = 6 * matmul_params * B * S + 12 * (d // heads) * pairs * L
    out = {"phase": "train_bert", "model": "bert_base",
           "config": dataclasses.asdict(cfg), "layers": L,
           "dtype": "bfloat16", "B": B, "S": S, "tokens_per_step": B * S,
           "mlm_share": b["mlm_share"], "steps": steps,
           "warmup_steps": b["warmup"], "warmup_losses": warmup,
           "optimizer": "AdamW lr 1e-4, weight decay 0.01, betas (0.9, "
                        "0.999), eps 1e-8, f32 moments",
           "remat": False, "losses": losses,
           "step_ms_median": 1e3 * step_med,
           "step_ms": [1e3 * t for t in step_s],
           "fwd_bwd_ms": 1e3 * fwd_bwd_s, "tokens_per_s": B * S / step_med,
           "peak_mem_gb": peak_gb, "step_flops": flops,
           "matmul_params": matmul_params,
           "mfu": flops / step_med / BF16_FLOP_PER_S,
           "mfu_formula": "(6*matmul_params*tokens + 12*head_dim*pairs*"
                          "layers) / step_s / 989e12; matmul_params = "
                          "L*(4d^2 + 2dF) + d^2 (MLM transform) + dV (tied "
                          "head), the pooler and NSP head left out (they "
                          "act on B rows); pairs = B*heads*S^2 "
                          "(non-causal)",
           "launches": counts, "launches_expected": want,
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_diff": abs(loss_k - loss_p), "loss_atol": BERT_LOSS_ATOL,
           "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
           "grad_rel_err_median": statistics.median(rel.values()),
           "grad_rel_limit": BERT_GRAD_REL, "grad_rel_err": rel,
           "noise_grad_rel_err_max": max(noise.values())}
    ok = (counts == want and all(np.isfinite(losses))
          and losses[-1] < losses[0] and out["loss_diff"] <= BERT_LOSS_ATOL
          and rel[worst] <= BERT_GRAD_REL)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("train_bert phase failed: " + json.dumps(
            {k: v for k, v in out.items() if k != "grad_rel_err"}))
    if profile:
        emit({"phase": "profile_train_bert", **_profile(
            lambda: float(step(params, opt, *batch)[2]),
            {"flash_attention": ("causalwalk",),
             "log_softmax": ("softmax",), "matmul": MATMUL_NAMES}, n=3)})
    del model, params, opt, step
    torch.cuda.empty_cache()
    return out


# --- phase 12: ResNet-50 training (vision/models/resnet.py) ----------------

def _conv_fc_macs(model, x):
    """Multiply-adds of one image through every ``Conv1D/2D/3D`` and
    ``Linear`` of ``model``, from the shapes a forward of ``x`` (one image,
    eval mode, no gradient) gives them: a convolution's output elements x
    in / groups x the kernel's size, an fc's in x out."""
    from paddle_tpu_torch import nn as pnn

    macs, hooks = [0], []

    def conv(m, inp, out):
        macs[0] += out.numel() // out.shape[0] * m.weight[0].numel()

    def fc(m, inp, out):
        macs[0] += out.numel() // out.shape[0] * m.weight.shape[0]

    for m in model.modules():
        if isinstance(m, (pnn.Conv1D, pnn.Conv2D, pnn.Conv3D)):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, pnn.Linear):
            hooks.append(m.register_forward_hook(fc))
    was_training = model.training
    with torch.no_grad():
        model.eval()(x)
    model.train(was_training)
    for h in hooks:
        h.remove()
    return macs[0]


def _resnet_batch(B, hw, classes, seed, dev, dtype):
    """Class-template images plus noise (``tests/test_resnet_train.py``'s
    recipe), made on ``dev`` by one seeded generator: a template N(0, 1)
    per class that the batch draws, labels uniform over the classes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randint(0, classes, (B,), generator=g, device=dev)
    labels, idx = torch.unique(y, return_inverse=True)
    templates = torch.randn((len(labels), 3, hw, hw), generator=g,
                            device=dev)
    x = templates[idx] + 0.3 * torch.randn((B, 3, hw, hw), generator=g,
                                           device=dev)
    return x.to(dtype), y


def phase_train_resnet50(dev, profile=False):
    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.vision.models import (resnet50,
                                                resnet_train_step_factory)

    r = RESNET
    B, hw, steps, seed = r["B"], r["hw"], r["steps"], r["seed"]
    model = resnet50(num_classes=r["classes"], device=dev,
                     generator=Generator(seed)).to(torch.bfloat16)
    x, y = _resnet_batch(B, hw, r["classes"], seed + 1, dev, torch.bfloat16)
    macs = _conv_fc_macs(model, x[:1])
    params, bufs, opt, step = resnet_train_step_factory(model, device=dev)
    n_params = sum(p.numel() for p in params.values())

    def fwd_bwd():
        logits = model.train()(x)
        logp = torch.log_softmax(logits.float(), -1)
        loss = -logp.gather(-1, y[:, None])[:, 0].mean()
        torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()

    # the forward and backward alone (no update), warm, host clock; the
    # batch norms blend their statistics as a step's forward does
    fwd_bwd()
    t0 = time.perf_counter()
    fwd_bwd()
    fwd_bwd_s = time.perf_counter() - t0

    # the main path: a warm-up step, then launch counts from 0 and the
    # timed steps, each up to its loss on the host
    warmup = [float(step(params, bufs, opt, x, y)[3])
              for _ in range(r["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(params, bufs, opt, x, y)[3]))
        step_s.append(time.perf_counter() - t0)
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_med = statistics.median(step_s)
    flops = 3 * 2 * macs * B
    dtypes = {"params": sorted({str(p.dtype) for p in params.values()}),
              "buffers": sorted({str(b.dtype) for b in bufs.values()}),
              "masters": sorted({str(m.dtype)
                                 for m in opt["master"].values()})}
    out = {"phase": "train_resnet50", "model": "resnet50",
           "classes": r["classes"], "params": n_params, "dtype": "bfloat16",
           "dtypes": dtypes, "layout": "NCHW", "B": B,
           "image": [3, hw, hw], "steps": steps, "warmup_steps": r["warmup"],
           "warmup_losses": warmup,
           "optimizer": "momentum SGD, lr 0.1, momentum 0.9, L2 decay 1e-4 "
                        "coupled into every gradient, f32 velocity and "
                        "masters",
           "losses": losses, "step_ms_median": 1e3 * step_med,
           "step_ms": [1e3 * t for t in step_s],
           "fwd_bwd_ms": 1e3 * fwd_bwd_s, "images_per_s": B / step_med,
           "peak_mem_gb": peak_gb, "macs_per_image": macs,
           "step_flops": flops, "mfu": flops / step_med / BF16_FLOP_PER_S,
           "mfu_formula": "3 * 2 * macs_per_image * B / step_s / 989e12; "
                          "macs_per_image summed over every convolution "
                          "(output elements x in/groups x kernel size) and "
                          "the fc (in x out) at this image size; batch "
                          "norms, ReLUs, pools and the update not counted",
           "launches": counts, "launches_expected": {k: 0 for k in counts}}
    ok = (counts == out["launches_expected"] and all(np.isfinite(losses))
          and losses[-1] < losses[0]
          and dtypes == {"params": ["torch.bfloat16"],
                         "buffers": ["torch.float32"],
                         "masters": ["torch.float32"]})
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("train_resnet50 phase failed: "
                             + json.dumps(out))
    if profile:
        emit({"phase": "profile_train_resnet50", **_profile(
            lambda: float(step(params, bufs, opt, x, y)[3]),
            {"pooling": ("pool",),
             "layout": ("nchwtonhwc", "nhwctonchw"),
             "convolution": ("conv", "xmma", "fprop", "dgrad", "wgrad",
                             "implicit", "cudnn", "sm90_"),
             "matmul": MATMUL_NAMES,
             "elementwise_and_reductions": ("elementwise", "reduce")},
            n=3)})
    del model, params, bufs, opt, step, x, y
    torch.cuda.empty_cache()
    return out


# --- main -------------------------------------------------------------------

PHASES = ("build", "kernel", "reference", "serve", "train", "train_mha",
          "train_window", "train_full", "train_long", "train_encoder",
          "train_bert", "train_resnet50")


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


def _phase_launches(trains, phases):
    """The launch counts of those of ``phases`` that ran, summed, and each
    one's own counts."""
    runs = {p: trains[p]["launches"] for p in phases if p in trains}
    total = {}
    for counts in runs.values():
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return total, runs


def _attention_entries(prefix, source, replaces_fwd, replaces_bwd, kind,
                       case, launches, card, by_phase=None):
    """The forward and backward entries of one attention kind, from its
    kernel-phase case at the main path's shapes and the launches of the
    train phases that run it (``by_phase``: each phase's own counts)."""
    fwd = _entry(f"{prefix}_fwd", source, replaces_fwd,
                 launches.get(f"{kind}_fwd"), case, "fwd", "fwd",
                 ("out", "lse"), card)
    bwd = _entry(f"{prefix}_bwd", source, replaces_bwd,
                 (launches[f"{kind}_dq"] + launches[f"{kind}_dkv"])
                 if launches else None,
                 case, None, "bwd", ("dq", "dk", "dv"), card,
                 ms=case["ms_dq"] + case["ms_dkv"],
                 bound=case["bounds"]["bwd"])
    bwd.update({"ms_dq": case["ms_dq"], "ms_dkv": case["ms_dkv"],
                "bound_ms_dq": case["bounds"]["dq"]["bound_ms"],
                "bound_ms_dkv": case["bounds"]["dkv"]["bound_ms"],
                "launches_dq": launches.get(f"{kind}_dq"),
                "launches_dkv": launches.get(f"{kind}_dkv")})
    for e in (fwd, bwd):
        e["library"] = case["library"]
    if by_phase:
        fwd["launches_by_phase"] = {p: n[f"{kind}_fwd"]
                                    for p, n in by_phase.items()}
        bwd["launches_by_phase"] = {
            p: {"dq": n[f"{kind}_dq"], "dkv": n[f"{kind}_dkv"]}
            for p, n in by_phase.items()}
    return [fwd, bwd]


def _norm_entry(name, replaces, launches, cases, kind, card, path):
    """The entry of one norm kernel: the numbers of its first kernel-phase
    case (the shape that heads its row), the worst error over all its
    cases, and its launches."""
    mine = [c for c in cases if c["kind"] == kind]
    head = mine[0]
    return {"name": name, "route": "cuda", "source": NORM_SOURCE,
            "replaces": replaces, "launches": launches, "path": path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_err_over_tol": max(c["max_err_over_tol"] for c in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_kernels": head["library_kernels"], "check": "pass",
            "card": card, "case": head["case"],
            "cases": [{k: c[k] for k in ("case", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms",
                                         "library_ms")} for c in mine]}


def _kernels_line(kern, serve, trains, card):
    kernels = []
    cases = kern.get("paged", [])
    main_case = next((c for c in cases if c["case"] == "decode/bfloat16"),
                     None)
    if main_case is not None:
        # the serve run's launches by the instance the kernel reported
        by_instance = serve.get("launches_by_instance", {})
        kernels.append({
            "name": "paged_attention", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": serve.get("launches"),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_err_over_tol": max(c["max_err_over_tol"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": None,
            "check": "pass", "card": card,
            "instances": {
                name: {"kernel": fn, "launches": by_instance.get(name),
                       "cases": [c["case"] for c in cases
                                 if c["instance"] == name]}
                for name, fn in (("split", "paged_attention_split_kernel"),
                                 ("mma", "paged_prefill_mma"),
                                 ("rows", "paged_attention_kernel"))},
            "cases": [{k: c[k] for k in ("case", "instance", "n_split",
                                         "max_abs_err", "max_err_over_tol",
                                         "bitwise_repeat", "ms", "plain_ms",
                                         "bound_ms", "bound_by")}
                      for c in cases]})
    # the GQA and CE kernels at B=2, S=4096 (G = 4) run in train and
    # train_full; the GQA kernels at G = 3, S=8192 in train_long
    launches, by_phase = _phase_launches(trains, ("train", "train_full"))
    if kern.get("gqa"):                     # [0]: the training shapes
        kernels += _attention_entries("gqa_flash", GQA_SOURCE,
                                      GQA_FWD_REPLACES, GQA_BWD_REPLACES,
                                      "gqa", kern["gqa"][0], launches, card,
                                      by_phase)
    if kern.get("gqa_long"):
        long_launches, long_by_phase = _phase_launches(trains,
                                                       ("train_long",))
        kernels += _attention_entries("gqa_flash_long", GQA_SOURCE,
                                      GQA_FWD_REPLACES, GQA_BWD_REPLACES,
                                      "gqa", kern["gqa_long"][0],
                                      long_launches, card, long_by_phase)
    if kern.get("ce"):
        c = kern["ce"][0]
        for name, replaces, part, errs in (
                ("fused_ce_fwd", CE_FWD_REPLACES, "fwd", ("loss", "lse")),
                ("fused_ce_bwd", CE_BWD_REPLACES, "bwd", ("dx",))):
            e = _entry(name, CE_SOURCE, replaces, launches.get(f"ce_{part}"),
                       c, part, part, errs, card)
            e["launches_by_phase"] = {p: n[f"ce_{part}"]
                                      for p, n in by_phase.items()}
            kernels.append(e)
    if kern.get("mha"):
        kernels += _attention_entries(
            "flash_mha", GQA_SOURCE, MHA_FWD_REPLACES, MHA_BWD_REPLACES,
            "mha", kern["mha"][0],
            trains.get("train_mha", {}).get("launches", {}), card)
    if kern.get("splash"):
        kernels += _attention_entries(
            "splash", SPLASH_SOURCE, SPLASH_FWD_REPLACES,
            SPLASH_BWD_REPLACES, "splash", kern["splash"][0],
            trains.get("train_window", {}).get("launches", {}), card)
    enc_launches = trains.get("train_encoder", {}).get("launches", {})
    if kern.get("mha_encoder"):
        # the multi-head kernels again, at the train_encoder phase's call
        kernels += _attention_entries(
            "flash_mha_encoder", GQA_SOURCE, MHA_FWD_REPLACES,
            MHA_BWD_REPLACES, "mha", kern["mha_encoder"][0], enc_launches,
            card)
    if kern.get("mha_encoder"):
        # and at the train_bert phase's call: the same shapes
        kernels += _attention_entries(
            "flash_mha_bert", GQA_SOURCE, MHA_FWD_REPLACES,
            MHA_BWD_REPLACES, "mha", kern["mha_encoder"][0],
            trains.get("train_bert", {}).get("launches", {}), card)
    norm = kern.get("norm", [])
    if norm:
        kernels += [
            _norm_entry("fused_layer_norm", LN_REPLACES,
                        sum(c["launched_once"] for c in norm
                            if c["kind"] == "ln"), norm, "ln", card,
                        "entry point only: one checked launch per kernel-phase case"),
            _norm_entry("fused_rms_norm", RMS_REPLACES,
                        sum(c["launched_once"] for c in norm
                            if c["kind"] == "rms"), norm, "rms", card,
                        "entry point only: one checked launch per kernel-phase case"),
            _norm_entry("dropout_add_ln", DLN_REPLACES,
                        enc_launches.get("dropout_add_ln"), norm, "dln",
                        card, "train_encoder: 2 per layer and step")]
    return kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also profile decode steps of the serve phase and "
                         "train steps of the train phases")
    ap.add_argument("--plain-curves", action="store_true",
                    help="in the Llama train phases, also run the 5 steps "
                         "with the plain attention and CE versions on the "
                         "same weights and batch, and record both loss "
                         "curves")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    kern, serve, trains = {}, {}, {}
    if "build" in phases:
        phase_build()
    if "kernel" in phases:
        kern = phase_kernel(dev)
    if "reference" in phases:
        phase_reference(dev)
    if "serve" in phases:
        serve = phase_serve(dev, profile=args.profile)
        torch.cuda.empty_cache()
    for phase in TRAIN_CELLS:
        if phase in phases:
            trains[phase] = phase_train(dev, phase, profile=args.profile,
                                        plain_curves=args.plain_curves)
    for phase in DEPTH_CELLS:
        if phase in phases:
            trains[phase] = phase_train_depth(dev, phase)
    if "train_encoder" in phases:
        trains["train_encoder"] = phase_train_encoder(dev,
                                                      profile=args.profile)
    if "train_bert" in phases:
        trains["train_bert"] = phase_train_bert(dev, profile=args.profile)
    if "train_resnet50" in phases:
        trains["train_resnet50"] = phase_train_resnet50(
            dev, profile=args.profile)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    emit({"kernels": _kernels_line(kern, serve, trains, card)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
