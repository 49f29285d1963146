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
    python3 chip_smoke.py --phases kernel,reference,train_eager
    python3 chip_smoke.py --phases build,reference,train_resnet50
    python3 chip_smoke.py --phases build,reference,train_full,train_long
    python3 chip_smoke.py --phases build,reference,train_moe
    python3 chip_smoke.py --phases build,reference,serve_engine
    python3 chip_smoke.py --phases build,reference,serve_features
    python3 chip_smoke.py --phases build,serve_cluster
    python3 chip_smoke.py --phases build,reference,serve_tiers,decode_options
    python3 chip_smoke.py --phases build,reference,train_gpt,transformer,\
fused_decode
    python3 chip_smoke.py --phases build,reference,train_rnnlm
    python3 chip_smoke.py --phases build,train_layer
    python3 chip_smoke.py --phases build,fit
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
   once, and the paged calls and the attention kernels (forward, dq,
   dk/dv) launched twice on the same inputs must give the same bits.
   Times are CUDA events (median of ``REPS``, L2 flushed before each
   call) beside the bound (the least
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
     G = 1 over 32 kv heads (Llama-2-7B's), at G = 8, and over int8
     pools of 32-token pages (serve_cluster's int8 replica); the 256-token
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
     than the kernels' tiles) and f32; then at ``F.block_sparse_attention``'s
     call (``block_sparse``: B=4, 12 heads, S=4096, head_dim 64, bf16, a
     BigBird pattern of 128 x 128 blocks: 3 sliding, 2 global, 3 random a
     row from a seed), the wrappers as above, then the entry point forward
     and backward through the kernels (one launch of each, counted from 0)
     against the same call with their plain versions;
     the yardstick of the three attention kinds is
     ``F.scaled_dot_product_attention`` (causal, or the live pairs as a
     boolean mask; K/V repeated where a backend refuses ``enable_gqa``)
     forward, and its backward alone, with the backend that ran it;
   * grouped flash attention once more at the train_long phase's call:
     B=1, 24 query / 8 kv heads (G = 3), S=8192, head_dim 128, bf16,
     causal; and at the train_moe phase's: B=1, 28 query / 4 kv heads
     (G = 7), S=4096, head_dim 128, bf16, causal;
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
   where the CPU's does. Then ``ServingEngine`` on the fixed clock over
   the serving factory of a small f32 Llama (hidden 256, 4 / 2 heads,
   head_dim 64, 2 layers, vocab 97; pages of 16, 4 slots), on the card
   and on the CPU, under the routed, dense and paged policies, on one
   mixed trace (Poisson singles with churn merged with a uniform burst):
   outputs identical across devices and policies, slot logs and reports
   identical across devices, the dense policy on the dense backend, the
   paged policy on the paged one, the paged kernel launched on the card;
   and the routed run once more with ``kv_quant="int8"`` (int8 pages and
   dense caches) through the constructor's model path, card against CPU.
   Then the engine's options on the same model, paged, fixed clock, card
   against CPU (identical outputs and slot logs): a LoRA engine
   (``lora=(4, 4)``, 3 adapters, a Zipf-adapter trace), whose
   adapter-free rows equal a plain engine's; a grammar engine (2 JSON
   schemas, a schema trace), every constrained stream parsing under its
   schema and the free rows equal to a plain engine's; a spec engine with
   an independent seeded draft (hidden 128, head_dim 64), its streams
   equal to the plain engine's, and with the target's own weights as a
   perfect draft, acceptance at least 0.99; the ragged lane
   (``prefill_chunk_budget=2``) equal to the per-chunk lane. The memory
   tiers and dispatch-ahead on the same model, paged, fixed clock, card
   against CPU (identical outputs, slot logs, censuses and tier stats):
   a pressure engine (17 pages, a budget of 8 full-precision pages: pages
   compacted), a host-memory engine (9 pages, a 1 MiB arena, two-turn
   sessions and a priority-9 request: spills, page-ins, a preemption and
   its restore; every arena tensor pinned host memory), and dispatch-ahead
   with the ragged lane (equal to the flag-off engine, turns served from
   its stash). The dense decode options on small f32 Llamas, card against
   CPU: int8 weights with the int8 cache (hidden 256) and the rolling
   cache (window 8 under max_len 16, a 12-token prompt) give the same
   greedy tokens and teacher-forced logits within ``REF_ATOL``; the
   speculative factory (a hidden-256 target, a 1-layer draft) the same
   tokens and stats, equal to plain greedy. Last, a small
   f32 MoE (``MOE_SMALL``: hidden 256, 4 / 2 heads, head_dim 64, 8 routed
   experts and one shared expert, 2 layers, B=2, S=256: the grouped flash
   kernels) card against CPU for each dispatch mode ("indexed",
   "inverted", "einsum") and gate (top-1 in eval mode, top-1 in training
   mode with its router noise, top-2, top-4 and expert choice): logits
   and aux loss within ``REF_ATOL``, then 3 steps of
   ``moe_train_step_factory`` under ``TRAIN_REF``. The top-1 noise is
   drawn on the card from a seeded generator; the CPU run takes the same
   draws (a generator of the card with that seed, copied over). Then
   this slice's three small f32 models, card against CPU from the same
   weights: GPT ``tiny()`` (logits within ``REF_ATOL``, 8 greedy tokens
   identical, 3 steps of ``gpt_pretrain_step_factory`` under
   ``TRAIN_REF``); an ``nn.Transformer`` (``SEQ2SEQ_SMALL``: d 128, 2
   heads, 2 + 2 layers, B=2, S=256 on both sides: the encoder's and the
   cross-attention's multi-head flash kernels on the card) under its
   causal target mask within ``REF_ATOL``; a ``FusedMultiTransformer``
   (``FUSED_SMALL``) within ``REF_ATOL``; and on each device a decode
   through the caches (the Transformer's ``Cache`` / ``StaticCache``
   pairs over 32 positions, the fused stack's ``caches`` / ``time_step``
   over 32 tokens) equal to the no-cache forward within ``DECODE_ATOL``.
   Then the op namespace and the recurrent layers (``op_sweep``): every
   case of ``tests/torch_op_cases.py`` (every op of ``OP_REGISTRY`` and
   every other public function of ``ops``) through the port on the card
   against the port on the CPU, values within the case's tolerance
   (exact for integers, bools and copies; 1e-6 + 1e-6 rel; 1e-6 + 1e-5
   rel for transcendental functions and reordered sums; eigenvectors, Q
   and singular vectors up to sign, ``eig``'s values sorted,
   ``lstsq``'s solution alone) and gradients within 1e-5 + 1e-5 rel (not
   compared where the card's solver chose another sign); each
   random op twice from one seed on the card, equal draws; 2-layer
   bidirectional LSTM / GRU / SimpleRNN stacks (16 -> 32, B=4, T=6) in
   both ``time_major`` forms, outputs and every gradient within 1e-5 +
   1e-5 rel; a small LM (vocab 64, hidden 32) for 3 SGD steps under
   ``TRAIN_REF`` and its beam-search ids and lengths identical.
4. ``serve``: Llama-3-8B at full width and 8 of its 32 layers (printed as
   ``cut``: ``serve_engine`` serves all 32), bf16, random weights
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
5. ``serve_engine``: Llama-3-8B at full width and depth, bf16, random
   weights from a seed, through ``llama_serving_decode_factory`` (max_len
   2048, pages of 64, 8 x 32 + 1 pool pages, dense capacity 8, chunked
   prefill of 64 by the plain page gather, as the reference builds it)
   and ``ServingEngine(slots=8, policy="routed", expect_churn=False)``.
   The trace: a uniform burst of 8 requests that arrives alone (prompts
   256-512, 32-64 new tokens), then 24 Poisson singles (prompts 128-1024,
   32-128 new tokens, half opening with one of two 256-token prefixes, a
   fifth cancelled early), ``ENGINE_INTERARRIVAL`` apart on average.
   First the first 12 requests on the fixed clock, twice: outputs and
   slot logs identical. Then the kernel's counts are set to 0, the 32
   requests run on the measured clock (each backend call timed up to its
   result on the card), and the counts are read: exactly 32 ``split``
   launches a paged decode step, no ``mma`` or ``rows`` (prefill chunks
   attend by the gather, the dense wave in plain PyTorch). Also checked:
   every stream has min(budget, cancel_after) tokens, the pool's census
   (resident + evictable + free == pool) holds, a dense and a paged wave
   ran. Records tokens/s on the wall clock, TTFT p50/p95 and TPOT p50 of
   ``report()``, the median decode turn, prefill chunk and dense step
   (from the run's trace spans), ``engine_host_frac``, the routing
   decisions by backend and rule, prefix-cache hits and peak memory.
6. ``serve_features``: Llama-3-8B at full width and 16 of its 32 layers
   (printed as ``cut``), bf16, seeded weights, through ``llama_serving_decode_factory`` (the serve_engine
   phase's build) and ``ServingEngine(slots=8, policy="paged")``, two
   engines in turn, each freed before the next. First multi-LoRA +
   grammar + the ragged lane: ``lora=LoRAConfig(4, 16)`` (3 adapters from
   ``synthesize_lora_deltas(cfg, 16, seed=i)``), ``grammar=GrammarConfig(3,
   64)`` (2 JSON schemas, compiled on the host once before the measured
   run, their host ms printed), ``ragged_prefill=True,
   prefill_chunk_budget=256``, on 16 Zipf-adapter requests (prompts
   128-512, 32-64 new tokens, a quarter base-model) merged with 8 schema
   requests (prompts 64-256), arrivals spread over one second. Then
   speculative decoding, ``SpecConfig(n_draft=3, accept_floor=0.0)``,
   with a draft at Llama-3.2-1B's widths (16 layers, hidden 2048, 32 / 8
   heads, head_dim 64, tied; one cut: plain rope) on 16 Poisson requests
   (prompts 128-512, 32-96 new tokens, a fifth cancelled early). Each
   engine replays its first 8 requests twice on the fixed clock
   (identical outputs and slot logs), then serves its trace on the
   measured clock between a reset and a read of the paged kernel's counts;
   the spec trace then runs once more without spec on the same factory.
   Checks: every stream has min(budget, cancel_after) tokens or stops at
   its grammar's accept; every constrained stream parses under its
   schema; the adapter, grammar and page censuses hold; paged launches
   == 16 x the plain decode steps, all ``split`` (the spec round, the
   ragged lane and prefill attend by the page gather); spec rounds > 0
   with an acceptance rate in [0, 1]. Records, per engine: requests
   completed and cancelled, tokens, tokens/s on the wall clock, TTFT
   p50 / p95, TPOT p50, the median decode turn, ragged lane call, prefill
   call and spec round, adapter and grammar cache stats, spec stats, the
   launches by instance, peak memory; and the share of the spec engine's
   streams equal to the plain run's, and where each first differs (bf16:
   recorded, not held), then the same in f32 at 2 layers of target and
   draft over the first 8 requests (``f32_control``: recorded).
7. ``serve_cluster``: the multi-replica serving layer. First the small
   f32 Llama of the reference phase as a 2-replica ``ClusterRouter`` on
   the fixed clock, on the card and on the CPU: ``least_loaded`` over two
   factories (its outputs equal a lone engine's) and ``disaggregated``
   with an int8 decode replica of 8-token pages (every handoff re-paged
   and transcoded); outputs, slot logs and censuses card against CPU.
   Then three factories of one seeded Llama-3-8B (16 of its 32 layers,
   printed as ``cut``, bf16): A and
   B over bf16 pools of 64-token pages, C over int8 pools of 32-token
   pages holding the same 16,384 tokens; each replica a
   ``ServingEngine(slots=8, policy="paged")`` on one of them, all on
   ``serve_engine``'s trace (the fixed-clock parts with its arrivals from
   0 in units of ``ENGINE_INTERARRIVAL``). Placement: the first 12 requests
   through ``least_loaded`` over A + B twice (identical outputs, slot
   logs, census) and through a lone engine on A (every stream equal, in
   bf16 too); ``least_loaded`` and ``prefix_aware`` on the measured clock
   over the first 16 requests.
   Drain and join: ``r1`` drained and ``r2`` on C joined at the median
   arrival (zero resident pages at removal). Disaggregated: ``r0``
   prefills on A, ``r1`` decodes on B (a twin, no transform), then on C
   (``resharded == {"page": 32, "codec": 32}``). Chaos: a fault-free
   run, then ``synthesize_fault_plan(seed=0)`` over the arrivals' span
   under ``FailoverConfig()`` (no request lost, duplicated or failed, at
   least one retried; the streams that match the fault-free run,
   recorded). Every replay: the
   census conserved, every stream min(budget, cancel_after) tokens,
   paged launches == 16 x the decode steps summed over the replicas, all
   ``split``, and those over int8 pages == 16 x the int8 replica's steps.
   Records wall s and tokens/s, the router's virtual rollup (one card a
   replica: not a speed of this card), TTFT / TPOT p50 / p95, placements
   and prefix hits a replica, handoffs and the transforms' ms (the spans'
   host wall, and CUDA events on a 500-token chain), retries, resumed
   tokens, incidents, peak memory.
7b. ``serve_tiers``: Llama-3-8B at full width and depth, bf16, seeded
   weights, ``serve_engine``'s geometry (``SERVE_TIERS``), through
   ``ServingEngine(slots=8, policy="paged")``. Dispatch-ahead:
   ``serve_engine``'s first 12 requests on the fixed clock with the flag
   off and on (identical outputs, slot logs and reports), then its 32 on
   the measured clock, off and on: tokens/s, TPOT p50, the median paged
   turn, and the stashes served against those discarded. Pressure:
   ``kv_quant="pressure"`` with ``kv_quant_budget`` at 60 % of the
   full-precision pool and a QoS scheduler whose SLO monitor (a
   ``ThresholdRule`` on the pool's stored bytes at 50 %) trips the tier,
   on the 32 requests, measured clock: compaction batches and quantized
   pages > 0, the stored bytes never above the budget, and the share of
   streams equal to the untiered (flag-off) run's. Host memory: 8
   two-turn sessions and 2 priority-9 requests on a pool of 41 pages
   with a 1 GiB arena, fixed clock: page-outs, page-ins, preemptions and
   restores > 0, the arena's census and budget held, every tensor it
   took pinned host memory; the CUDA-event ms of one page's spill and
   page-in; the share of streams equal to the same trace on the ample
   pool. Every run: streams min(budget, cancel_after) tokens, the page
   census conserved, paged launches == 32 x decode steps (a discarded
   dispatched-ahead batch's steps included), all ``split``.
7c. ``decode_options``: int8 weights (``llama_decode_factory(
   weight_dtype="int8")``) on Llama-3-8B, B=8, a 512-token prompt, 64
   tokens, against the bf16 factory: ms a token, the projection weights'
   stored bytes (int8 + scales, at most 0.52 of bf16) and the
   teacher-forced logits' relative error (``INT8_LOGIT_REL``), alone and
   with the int8 KV cache. The rolling cache on Mistral-7B's widths
   (window 4096, 32 layers), B=1, a 4608-token prompt (the rolled
   prefill), 64 tokens: the cache holds 4096 slots, and the teacher-forced
   decode logits agree with the model's own windowed forward (the splash
   forward kernel, once a layer) within ``ROLLING_LOGIT_REL``. The
   speculative factory, a Llama-3-8B target with a draft at
   Llama-3.2-1B's widths (seeded, untrained), n_draft 4, 128 tokens:
   ``last_stats`` and ms a token against plain greedy, the share of
   tokens equal (bf16: recorded); in f32 at 2 layers, the target as its
   own draft, exactly the target's greedy tokens in fewer than
   ceil(128 / 3) target steps. No paged launch.
8. ``train``, ``train_mha``, ``train_window``: Llama-3-8B (GQA, B=2,
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

9. ``train_full`` and 10. ``train_long``: Llama-3-8B at all 32 layers (the
   host's memory permitting: else the deepest cut whose moments it can pin, printed as
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

11. ``train_moe``: the Mixture-of-Experts model at Qwen2-57B-A14B's
   widths (``MoEConfig.qwen2_57b_a14b()``: hidden 3584, 28 / 4 heads, 64
   routed experts of 2560 top-8 at capacity factor 1.25, one 20480-wide
   shared expert, vocabulary 151,936, tied head), bf16, seeded, through
   ``examples/train_moe.train`` and ``moe_train_step_factory``: dispatch
   "indexed", the chunked CE in chunks of 16384, no remat, AdamW lr 1e-4,
   B=1 x S=4096 on one repeated batch. Depth is the one cut: the deepest
   whose bf16 weights and gradients and f32 moments, plus the step's
   peak above them and a margin for the allocator's fragments, fit the
   card's free memory (``fitting_depth``; printed as ``cut``). First, at
   full width and 2 layers, one forward and backward with the grouped
   flash kernels (G = 7) and one with their plain versions on identical
   weights and batch: |Δloss|, every parameter's relative gradient error
   (by kind: router, experts (and each expert), shared expert, attention;
   the routed ones, whose error follows the flips, held apart), and the
   share of expert choices that differ between the two runs (a bf16
   rounding in the attention can flip a near-tie in the bf16 router).
   Then the launch counts are set to 0, a warm-up step and 5 steps run,
   and the counts must be exactly layers grouped forward, layers dq and
   layers dk/dv a step and 0 of every other counter; the losses finite,
   the last below the first. Records step ms, tokens/s, ``fwd_bwd_ms``,
   the update (the step less it), MFU with ``activated_params()`` as the
   matmul parameters (the experts' capacity slack not counted), peak
   memory allocated and reserved, the parameter and moment bytes, the aux loss and the share of
   (token, choice) pairs dropped for capacity at the trained weights; with
   ``--profile`` (``profile_train_moe``) the step's device time by family
   (flash, matrix products, index / scatter / gather, elementwise,
   reductions, the rest), idle share and kernels a step.

12. ``train_encoder``: 12 post-LN ``FusedTransformerEncoderLayer``s of
   ``incubate.nn`` at BERT-base's widths (768, 12 heads, FFN 3072, GELU,
   dropout 0.1), bf16, random weights from a seed, on hidden states
   (B=32, S=512) against an N(0, 1) target (MSE), trained 5 steps on one
   batch with ``adamw_update`` (f32 moments, lr 1e-4) in training mode.
   First one forward and backward with the kernels and one with their
   plain versions, on identical weights and dropout draws; then the
   launch counts are set to 0, the 5 steps run, and the counts must be
   24 dropout-add-LN and 12 + 12 + 12 multi-head flash launches per step
   and none of any other kernel.

13. ``train_bert``: ``BertForPretraining`` at BERT-base (``BertConfig()``:
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

13b. ``train_eager``: the everyday Paddle loop on BERT-base (``BertConfig()``,
   f32 parameters, dropout live, B=32, S=512, ``train_bert``'s batch)
   through the port's eager training API: ``optimizer.AdamW`` over
   ``optimizer.lr.LinearWarmup(PolynomialDecay(1e-4, 1000, 0.0), 2, 0.0,
   1e-4)``, weight decay 0.01, ``nn.ClipGradByGlobalNorm(1.0)``,
   ``amp.GradScaler(init_loss_scaling=2**15)``; each step ``auto_cast``,
   the model and its ``loss`` (``F.cross_entropy``), ``scaler.scale(loss)
   .backward()``, ``scaler.minimize`` (which updates the scale itself),
   ``clear_grad``, ``scheduler.step()``. First one O1 forward and
   backward of a 2-layer BERT at full width with the multi-head flash
   kernels and one with their plain versions (identical weights, batch
   and dropout draws: |Δloss| and every parameter's relative gradient
   error). Then two parts from the same initial weights, each with a
   fresh optimizer, scheduler and scaler: O1 (``auto_cast(level="O1",
   dtype="bfloat16")``) and O2 (``amp.decorate``: bf16 parameters, f32
   masters). Each: a warm-up step under the op census
   (``ops.dispatch.census``: dtypes in and out by op name), the launch
   counts set to 0, 5 timed steps (host clock up to the loss on the
   host), then a forward and backward alone and one more whole step (the
   optimizer's share). Checks: losses finite and falling; exactly 12 + 12
   + 12 multi-head flash launches a step and no other kernel; the flash
   inputs bf16; under O1 every parameter f32, the layer norms' outputs
   and the CE's input f32; under O2 every parameter equal to its f32
   master rounded to bf16 after each step. Records step ms, tokens/s, MFU
   (``train_bert``'s count), peak memory, the optimizer's ms and share,
   the census.

14. ``train_resnet50``: ``resnet50()`` (1000 classes, full depth and
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

15. ``train_gpt``: ``GPTForCausalLM`` at ``GPTConfig()``'s GPT-2 small
    (vocab 50304, hidden 768, all 12 layers, 12 heads, FFN 3072, 1024
    positions), bf16, seeded, through ``gpt_pretrain_step_factory`` (its
    defaults; the model in ``eval()`` inside the step, as the
    reference's) on one seeded batch of ``GPT["B"]`` x 1024 next-token
    pairs: a warm-up step, then the launch counts are set to 0, 5 steps
    run, and every count must stay 0 (the additive causal mask keeps the
    attention on the plain path, as in the reference); the losses finite
    and falling. Then ``generate`` 16 greedy tokens from a 512-token
    prompt at B=1 (recomputed each token; 0 launches). Records step ms,
    tokens/s, MFU (the tied head once, causal live pairs), a forward and
    backward alone, peak memory and ms a generated token.
16. ``transformer``: ``nn.Transformer()`` at its defaults
    (Transformer-base: d 512, 8 heads, 6 + 6 post-LN layers, FFN 2048,
    ReLU, dropout 0.1 live), bf16, seeded, on embeddings of B=32 source
    and target sequences of 512 positions against an N(0, 1) target
    (MSE), the target under ``generate_square_subsequent_mask``. First one
    forward and backward with the multi-head flash kernels and one with
    their plain versions, identical weights, batch and dropout draws
    (|Δloss|, every parameter's relative gradient error; the key biases
    apart); then the launch counts are set to 0, 5 AdamW steps run, and
    the counts must be exactly 12 forward + 12 dq + 12 dk/dv a step (6
    encoder self-attentions and 6 cross-attentions: the decoder's
    self-attention carries its mask to the plain path) and none of any
    other kernel. Then a cached decode: ``TransformerDecoder.gen_cache``
    of 8 sources' memory and 128 one-token steps (0 launches). Records
    step ms, tokens/s, MFU, peak memory and ms a decode step.
17. ``fused_decode``: ``FusedMultiTransformer`` at GPT-2 small's widths
    (768, 12 heads, FFN 3072, 12 pre-LN layers, gelu), bf16, seeded,
    B=8, a (12, 8, 2, 12, 1024, 64) cache cast to bf16: 256
    token-by-token steps through ``caches`` / ``time_step`` (0
    launches). Records ms a token and peak memory.
18. ``train_rnnlm``: the "large" PTB LSTM language model of Zaremba,
    Sutskever & Vinyals (2014) at its published widths (vocab 10,000,
    embedding and 2 LSTM layers of 1500, unrolled 35, B=20, dropout 0.65
    on the non-recurrent connections, U(-0.04, 0.04), untied output, SGD
    lr 1 with ``ClipGradByGlobalNorm(10)``, f32; 66.0 M parameters), a
    Paddle user's script through the op namespace (``import
    paddle_tpu_torch as paddle``, ``set_device("gpu")``, ``to_tensor`` of
    numpy batches of a seeded synthetic Zipf stream, ``reshape``, the
    LSTM's states carried across batches with ``detach``): a warm-up
    step under the dispatch census (ops a step, float dtypes f32), then 5
    steps on the repeated batch (finite, falling, the first within 0.5
    of ln 10000), an eval pass under ``no_grad`` (``exp`` of the mean
    loss), and ``BeamSearchDecoder`` (beam 4, B=8, ``max_step_num`` 31:
    32 steps unless every beam ends first) over a user's
    ``RNNCellBase`` running the LM's two ``LSTMCell``s. No kernel of the
    port is on this path: every counter must read 0. Records step ms,
    tokens/s, the LSTM stack's forward + backward ms beside
    ``torch.nn.LSTM`` (cuDNN) with the same weights (a yardstick, never
    on the path), beam step ms and peak memory; with ``--profile``
    (``profile_train_rnnlm``) the step's device time by kernel family
    and the device's idle share.

19. ``train_layer``: a Paddle user's ``nn.Layer`` script, as written:
    ``paddle.set_device("gpu")``, a ``class LM(paddle.nn.Layer)``
    holding ``LlamaForCausalLM`` of Llama-3-8B at 4 of its 32 layers,
    full width, bf16 (1.9 B parameters), a forward pre-hook and post-hook
    counting calls, 5 steps of ``optimizer.AdamW(parameters=
    model.parameters(), multi_precision=True)`` on ``F.cross_entropy``
    at B=2 x S=4096 over seeded tokens. The loss must fall, every
    parameter tensor move, the hooks fire once a step, the grouped flash
    forward, dq and dk/dv launch 4 x 5 times each (every other counter
    0), ``state_dict()`` carry the reference's keys and a
    ``set_state_dict`` round trip give the same logits bit for bit; then
    ``generate`` 8 tokens from a 64-token prompt (tokens/s). Before it,
    card against CPU: every function and layer of the slice on small f32
    tensors (output and input gradients within ``SWEEP_TOL``), one eager
    step of a small f32 Llama at S=256 (the grouped kernels in f32) under
    ``TRAIN_REF``, a narrow f32 ``generate`` token for token, and one
    eager step of ``MoEForCausalLM(MoEConfig.tiny())`` moving 20 of 20
    tensors. Records step ms, tokens/s, MFU, peak memory and the phase's
    seconds.

20. ``fit``: a Paddle user's fine-tuning script through hapi, as
    written: ``class Tokens(paddle.io.Dataset)`` over seeded numpy ids
    (the label a function of the ids: 1 position in 4 holds an id of the
    class's own pool of 32), ``DataLoader(num_workers=4,
    persistent_workers=True)`` over the shared-memory worker processes
    (forked after the parent holds its CUDA context),
    ``paddle.Model(net).prepare(AdamW(LinearWarmup(5e-5, 2)),
    CrossEntropyLoss(), Accuracy())`` after ``amp.decorate(level="O2")``,
    ``fit`` for 2 epochs of 8 steps with an evaluation of 2 batches each
    epoch, ``EarlyStopping``, ``ReduceLROnPlateau`` and
    ``ModelCheckpoint(save_freq=2)``, then ``evaluate`` and ``predict``
    over 2 batches, and ``Model.load`` of the final checkpoint into a fresh
    ``Model`` whose predictions must equal the trained model's bit for
    bit. The network: ``nn.Embedding`` of BERT-base's vocabulary and
    width, 12 ``nn.TransformerEncoderLayer``s (768, 12 heads, FFN 3072,
    dropout 0.1), a mean pool and a 2-class head, bf16, B=32 x S=512:
    the multi-head flash kernels must launch exactly 12 x (training
    steps + evaluation, prediction and reload batches) forwards and 12 x
    training steps dq and dk/dv (every other counter 0), the loss fall
    and the evaluation's accuracy reach ``FIT_EVAL_ACC``. Before it: a
    2-layer f32 classifier (d 256, head_dim 64, S=256) takes 3 fit steps
    on the card and on the CPU from the same weights (losses within
    ``FIT_SMALL_LOSS_ATOL``, accuracy within one sample, predictions
    within ``REF_ATOL``); the shared-memory loader's 8 batches of the
    full run's dataset equal the synchronous loader's, byte for byte;
    a bf16 state dict keeps its bits through ``paddle.save`` /
    ``paddle.load``; every metric on card tensors equals its value on
    host numpy. Records step ms (median and range after the first),
    tokens/s, the loader's wait a batch inside ``fit`` and alone, the
    losses, the evaluation, each checkpoint's bytes and seconds, the
    load's seconds, peak memory and the phase's seconds, beside the
    card's name and power limit.

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
import os
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
# rounding apart per layer, carried through the serve phase's bf16 layers.
# Reading at 32 layers 0.238 (max |logit| 6.19); the limit, about twice
# it, stays at the phase's 8 (reading 0.102 there).
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
# train_eager: BertForPretraining at BertConfig()'s BERT-base, f32
# parameters, B=32, S=512, dropout live, trained by the everyday loop
# (auto_cast, GradScaler at 2**15, AdamW over LinearWarmup(PolynomialDecay),
# ClipGradByGlobalNorm(1.0), scheduler.step() after each step): O1, then O2
# (decorate: bf16 parameters, f32 masters) from the same initial weights;
# one warm-up step and 5 timed steps each. Kernels against plain versions:
# one O1 forward+backward of a 2-layer BERT at full width, identical
# weights, batch and dropout draws: bf16 roundings apart in the attention
# of each layer, carried into f32 gradients (O1 keeps f32 parameters, so
# no bf16 rounding of the gradients hides them). Readings: loss 0.00324
# apart (of 115.87); gradients 0.0179 median, 0.0360 worst (the position
# embedding, a sum over the batch of each position's gradient); the key
# biases apart (NOISE_GRAD_PARAMS: 0.57, 0.96). Limits about twice them
# (PERF.md §2).
EAGER = dict(B=32, S=512, steps=5, warmup=1, seed=0, lr=1e-4,
             check_layers=2)
EAGER_LOSS_ATOL = 0.0065
# the kernel phase's block_sparse case: F.block_sparse_attention at a
# long-document encoder's call, BigBird's pattern of 128 x 128 blocks
BLOCK_SPARSE = dict(B=4, S=4096, block=128, seed=0)
EAGER_GRAD_REL = 0.072
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
# train_gpt: GPTForCausalLM at GPTConfig()'s GPT-2 small (vocab 50304,
# hidden 768, 12 layers, 12 heads, FFN 3072, 1024 positions), bf16,
# seeded, all 12 layers, B x S = 8 x 1024 next-token pairs of one seeded
# batch, through gpt_pretrain_step_factory (its defaults: lr 1e-4, weight
# decay 0.01, betas (0.9, 0.95); the model in eval() inside the step);
# one warm-up step, then 5 timed; then generate 16 tokens greedily from a
# 512-token prompt at B = 1 (the recompute form)
GPT = dict(B=32, S=1024, steps=5, warmup=1, seed=0, prompt=512,
           new_tokens=16)
# transformer: nn.Transformer() at its defaults, Transformer-base (d 512,
# 8 heads, 6 + 6 layers, FFN 2048, ReLU, dropout 0.1 live), bf16, seeded,
# on embeddings of B=32 source and target sequences of 512 positions
# against an N(0, 1) target (MSE), the target side under
# generate_square_subsequent_mask; 5 AdamW steps (lr 1e-4, betas (0.9,
# 0.98), eps 1e-9, weight decay 0.01) on one batch. Then a cached decode:
# the encoder's memory of the batch's first 8 sources,
# TransformerDecoder.gen_cache(memory) (its empty float32 self-attention
# caches cast to bfloat16, so the decode stays in bfloat16), and 128
# one-token steps, each fed the step before's output
SEQ2SEQ = dict(B=32, S_src=512, S_tgt=512, steps=5, lr=1e-4, seed=0,
               decode_B=8, decode_steps=128)
# One forward+backward with the multi-head flash kernels against one with
# their plain versions, identical weights, batch and dropout draws: bf16
# roundings apart in the 12 attentions the kernels run (the forward
# rounds each probability against the running max, the plain version
# against the final one). Readings: loss 3.83e-5 apart (of 1.9994);
# gradients 0.0308 median, 0.129 worst (the last decoder layer's
# cross-attention k projection); the key biases apart (NOISE_GRAD_PARAMS,
# 1.47). Limits about twice them (PERF.md §2).
SEQ2SEQ_LOSS_ATOL = 8e-5
SEQ2SEQ_GRAD_REL = 0.26
# fused_decode: FusedMultiTransformer at GPTConfig()'s widths (768, 12
# heads, FFN 3072, 12 layers, pre-LN, gelu), bf16, seeded, B=8, its cache
# (L, B, 2, H, 1024, 64) cast to bfloat16 (gen_cache makes float32, which
# a bfloat16 step refuses, as the reference does); 256 token-by-token
# steps through caches / time_step on seeded N(0, 1) inputs
FUSED_DECODE = dict(B=8, max_len=1024, steps=256, seed=0)
# the reference phase's small f32 models of this slice: GPT at tiny()
# (its mask keeps it on the plain path); a Transformer at head_dim 64
# with S = 256 on both sides (the encoder's and the cross-attention's
# multi-head flash kernels on the card); a FusedMultiTransformer. Card vs
# CPU within REF_ATOL (logits, outputs) and TRAIN_REF (GPT's 3 factory
# steps; the key biases, whose gradient is noise, 2 x 3 x lr); each
# decode through its caches against the no-cache forward on the same
# device within DECODE_ATOL (f32: the order of the sums only, one token's
# products against the whole sequence's: a few ulps of outputs up to ~12;
# readings 1.4e-6 (Transformer) and 7.2e-6 (fused, card))
SEQ2SEQ_SMALL = dict(d_model=128, nhead=2, num_encoder_layers=2,
                     num_decoder_layers=2, dim_feedforward=256, dropout=0.0)
FUSED_SMALL = dict(embed_dim=128, num_heads=4, dim_feedforward=256,
                   num_layers=2)
DECODE_ATOL = 1e-5

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
    # the forward, dq and dk/dv once more on the same inputs: the same
    # bits (no atomics)
    again = (*fwd(q, k, v), dq(q, k, v, do, want_lse, delta),
             *dkv(q, k, v, do, want_lse, delta))
    repeat = all(torch.equal(a, b) for a, b in zip((out, lse, *grads),
                                                    again))
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


def _bigbird_mask(n, seed, sliding=3, n_global=2, n_random=3):
    """BigBird's block pattern over n x n blocks: each block row sees its
    ``sliding`` nearest blocks (itself and its neighbours), the first
    ``n_global`` blocks (which see every block) and ``n_random`` blocks
    drawn from ``seed``."""
    bm = np.zeros((n, n), bool)
    half = sliding // 2
    for i in range(n):
        bm[i, max(0, i - half):i + half + 1] = True
    bm[:, :n_global] = True
    bm[:n_global, :] = True
    rng = np.random.default_rng(seed)
    for i in range(n):
        bm[i, rng.choice(n, n_random, replace=False)] = True
    return bm


def _block_sparse_call(bm, dev, seed):
    """``F.block_sparse_attention`` forward and backward at a long-document
    encoder's call (B=4, S=4096, 12 heads, head_dim 64, bf16, (B, S, H, D)
    layout, 128 x 128 blocks), its launches counted from 0, against the
    same call with the splash kernels' plain versions on the same
    inputs."""
    from paddle_tpu_torch.nn import functional as F

    sa = importlib.import_module("paddle_tpu_torch.ops.splash_attention")
    B, S, H, D = BLOCK_SPARSE["B"], BLOCK_SPARSE["S"], 12, 64
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    plain = [(sa, "splash_fwd", sa._splash_fwd_plain),
             (sa, "splash_bwd", sa._splash_bwd_plain)]

    def run(swap):
        with _swapped(plain, swap):
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.block_sparse_attention(qs, ks, vs, bm, False,
                                           BLOCK_SPARSE["block"],
                                           BLOCK_SPARSE["block"])
            grads = torch.autograd.grad(out, (qs, ks, vs), do)
            torch.cuda.synchronize()
        return out.detach(), grads

    owner = sa.splash_attention
    owner.launches_fwd = owner.launches_dq = owner.launches_dkv = 0
    out, grads = run(False)
    launches = {"splash_fwd": owner.launches_fwd,
                "splash_dq": owner.launches_dq,
                "splash_dkv": owner.launches_dkv}
    want_out, want_grads = run(True)
    tol = GQA_TOL["bfloat16"]
    checks = {"out": _check(out, want_out, *tol["out"])}
    for n, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        checks[n] = _check(a, b, *tol["grad"])
    ok = (launches == {k: 1 for k in launches}
          and all(r <= 1.0 for _, r in checks.values()))
    return {"entry": "F.block_sparse_attention", "entry_ok": ok,
            "entry_launches": launches,
            "entry_checks": {n: {"max_abs_err": e, "max_err_over_tol": r}
                             for n, (e, r) in checks.items()}}


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
    # serve_cluster's int8 replica: int8 pools of 32-token pages (a page
    # shorter than the kernel's key tile), 64 pages a sequence
    cases.append(_kernel_case("decode_ps32/int8", 8, Hkv, G, D, 32, 64,
                              8 * 64 + 1, dec_lens, None, 1, "int8", 8, dev,
                              flush))
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
    # and at train_moe's call: Qwen2-57B-A14B's 28 / 4 heads (G = 7) at
    # S=4096
    gqa_moe = [_attention_case("gqa_G7_B1_S4096_D128/bfloat16", "gqa", 1, 4,
                               7, 4096, 4096, 128, "bfloat16", 81, dev,
                               flush)]
    for c in gqa + ce + gqa_long + gqa_moe:
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
    # the splash kernels at F.block_sparse_attention's call: a BigBird
    # pattern of 128 x 128 blocks at S=4096 (kernel wrappers, then the
    # entry point forward and backward against its plain versions)
    bs = BLOCK_SPARSE
    bs_mask = _bigbird_mask(bs["S"] // bs["block"], bs["seed"])
    block_sparse = [_attention_case(
        "block_sparse_bigbird_B4_S4096_D64_noncausal/bfloat16", "splash",
        bs["B"], 12, 1, bs["S"], bs["S"], 64, "bfloat16", 32, dev, flush,
        causal=False, mask=(bs_mask, bs["block"], bs["block"], None, 0))]
    block_sparse[0].update(_block_sparse_call(bs_mask, dev, 33))
    block_sparse[0]["ok"] = block_sparse[0]["ok"] and \
        block_sparse[0]["entry_ok"]
    block_sparse[0]["mask_live_blocks"] = int(bs_mask.sum())
    for c in block_sparse:
        emit({"phase": "kernel", **c})
    # the multi-head kernels at the train_encoder phase's call: BERT-base
    # width, non-causal
    mha_enc = [_attention_case("mha_encoder_B32_S512_D64_noncausal/bfloat16",
                               "mha", 32, 12, 1, 512, 512, 64, "bfloat16",
                               30, dev, flush, causal=False)]
    # and at the transformer phase's call: Transformer-base's 8 heads
    mha_enc.append(_attention_case(
        "mha_transformer_B32_S512_D64_noncausal/bfloat16", "mha", 32, 8, 1,
        512, 512, 64, "bfloat16", 31, dev, flush, causal=False))
    for c in mha_enc:
        emit({"phase": "kernel", **c})
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
    bad = [c["case"] for c in cases + gqa + ce + gqa_long + gqa_moe + mha
           + splash + block_sparse + mha_enc + norm if not c["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"or did not launch once: {bad}")
    del flush
    torch.cuda.empty_cache()
    return {"paged": cases, "gqa": gqa, "ce": ce, "gqa_long": gqa_long,
            "gqa_moe": gqa_moe, "mha": mha,
            "splash": splash, "block_sparse": block_sparse,
            "mha_encoder": mha_enc, "norm": norm,
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


def _params_agree(card, host):
    """(largest difference, largest share of a tensor's elements beyond
    ``TRAIN_REF["param"]``, largest count of them over max(1,
    ``TRAIN_REF["param_frac"]`` x its size), largest difference of the
    key biases) of two {name: parameter} dicts; the key biases
    (``NOISE_GRAD_PARAMS``), whose gradients are noise, apart."""
    param_max, param_frac, count_ratio, noise_max = 0.0, 0.0, 0.0, 0.0
    for k in host:
        d = (card[k] - host[k]).abs()
        if k.endswith(NOISE_GRAD_PARAMS):
            noise_max = max(noise_max, float(d.max()))
            continue
        beyond = d > TRAIN_REF["param"]
        param_max = max(param_max, float(d.max()))
        param_frac = max(param_frac, float(beyond.float().mean()))
        count_ratio = max(count_ratio, int(beyond.sum()) / max(
            1.0, TRAIN_REF["param_frac"] * d.numel()))
    return param_max, param_frac, count_ratio, noise_max


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
    param_max, param_frac, _, noise_max = _params_agree(card[3], host[3])
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


def _gpt_small(dev, state, ids, labels):
    """GPT tiny() on ``dev`` from ``state``: its logits, 8 greedy tokens
    from the first 16 ids, the losses of 3 factory steps and the
    parameters after them (each on the CPU)."""
    from paddle_tpu_torch.models.nlp import (GPTConfig, GPTForCausalLM,
                                             gpt_pretrain_step_factory)
    from paddle_tpu_torch.nn import load_numpy_state_dict

    model = load_numpy_state_dict(GPTForCausalLM(GPTConfig.tiny(),
                                                 device=dev), state)
    ids, labels = ids.to(dev), labels.to(dev)
    with torch.no_grad():
        logits = model(ids).cpu()
    tokens = model.generate(ids[:, :16], max_new_tokens=8).cpu()
    params, opt, step = gpt_pretrain_step_factory(
        model, learning_rate=TRAIN_REF["lr"], device=dev)
    losses = [float(step(params, opt, ids, labels)[2]) for _ in range(3)]
    return logits, tokens, losses, {k: p.detach().cpu()
                                    for k, p in params.items()}


def _reference_gpt(dev):
    """GPT tiny() (hidden 64, 4 heads, 2 layers, B=2, S=64) card against
    CPU from the same weights: logits within ``REF_ATOL``, greedy tokens
    identical, 3 factory steps under ``TRAIN_REF`` with its share of a
    tensor's elements read as max(1, 1e-4 x size) elements, as the MoE
    card test reads it: tiny()'s tensors hold 4096-16384 elements, where
    1e-4 of them is less than one, and AdamW steps an element whose
    gradient is as small as its f32 noise by about lr either way (the
    key biases, all noise, within 2 x 3 x lr)."""
    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.models.nlp import GPTConfig, GPTForCausalLM

    state = {k: v.numpy() for k, v in GPTForCausalLM(
        GPTConfig.tiny(), device="cpu", generator=Generator(11))
        .state_dict().items()}
    ids = torch.from_numpy(np.random.default_rng(15).integers(0, 256,
                                                              (2, 65)))
    args = (state, ids[:, :-1], ids[:, 1:])
    card = _gpt_small(dev, *args)
    host = _gpt_small(torch.device("cpu"), *args)
    logit_diff = float((card[0] - host[0]).abs().max())
    loss_diff = max(abs(a - b) for a, b in zip(card[2], host[2]))
    param_max, param_frac, count_ratio, noise_max = _params_agree(card[3],
                                                                  host[3])
    ok = (logit_diff <= REF_ATOL and torch.equal(card[1], host[1])
          and loss_diff <= TRAIN_REF["loss"] and count_ratio <= 1
          and param_max <= TRAIN_REF["lr"]
          and noise_max <= 2 * 3 * TRAIN_REF["lr"]
          and card[2][-1] < card[2][0])
    return {"gpt_logits_max_diff": logit_diff,
            "gpt_tokens_equal": torch.equal(card[1], host[1]),
            "gpt_losses_card": card[2], "gpt_losses_cpu": host[2],
            "gpt_loss_max_diff": loss_diff, "gpt_param_max_diff": param_max,
            "gpt_param_frac_over_atol": param_frac,
            "gpt_param_count_over_allowed": count_ratio,
            "gpt_noise_param_max_diff": noise_max, "gpt_ok": ok}


def _seq2seq_small(dev, state, src, tgt, n_decode):
    """The small f32 Transformer on ``dev`` from ``state``: its output
    under the causal target mask, and the largest difference between that
    output and a decode of the first ``n_decode`` positions one token at
    a time through ``TransformerDecoder``'s caches (``Cache`` for the
    self-attention, ``StaticCache`` for the memory)."""
    from paddle_tpu_torch.nn import Transformer, load_numpy_state_dict

    model = load_numpy_state_dict(
        Transformer(**SEQ2SEQ_SMALL, device=dev), state).eval()
    src, tgt = src.to(dev), tgt.to(dev)
    mask = Transformer.generate_square_subsequent_mask(tgt.shape[1],
                                                       device=dev)
    with torch.no_grad():
        out = model(src, tgt, tgt_mask=mask)
        memory = model.encoder(src)
        cache = model.decoder.gen_cache(memory)
        steps = []
        for t in range(n_decode):
            step, cache = model.decoder(tgt[:, t:t + 1], memory,
                                        cache=cache)
            steps.append(step)
        diff = float((torch.cat(steps, 1) - out[:, :n_decode]).abs().max())
    return out.cpu(), diff


def _fused_small(dev, state, x):
    """The small f32 FusedMultiTransformer on ``dev`` from ``state``: its
    no-cache forward, and the largest difference between it and a
    token-by-token decode through ``caches`` / ``time_step``."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.nn import load_numpy_state_dict

    model = load_numpy_state_dict(
        FusedMultiTransformer(**FUSED_SMALL, device=dev), state)
    x = x.to(dev)
    with torch.no_grad():
        out = model(x)
        cache = model.gen_cache(x.shape[0], x.shape[1])
        steps = []
        for t in range(x.shape[1]):
            step, cache = model(x[:, t:t + 1], caches=cache, time_step=t)
            steps.append(step)
        diff = float((torch.cat(steps, 1) - out).abs().max())
    return out.cpu(), diff


def _reference_decoders(dev):
    """A small f32 ``nn.Transformer`` (``SEQ2SEQ_SMALL``: d 128, 2 heads,
    head_dim 64, 2 + 2 layers, B=2, S=256 both sides: the encoder's and
    the cross-attention's flash kernels on the card) and a small f32
    ``FusedMultiTransformer`` (``FUSED_SMALL``, B=2, T=32), card against
    CPU from the same weights: outputs within ``REF_ATOL``; and on each
    device a decode through the caches (the Transformer's first 32
    positions, the fused stack's 32) equal to the no-cache forward within
    ``DECODE_ATOL``."""
    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.nn import Transformer

    rng = np.random.default_rng(16)
    src, tgt = (torch.from_numpy(rng.standard_normal((2, 256, 128))
                                 .astype(np.float32)) for _ in range(2))
    state = {k: v.numpy() for k, v in Transformer(
        **SEQ2SEQ_SMALL, device="cpu", generator=Generator(12))
        .state_dict().items()}
    card = _seq2seq_small(dev, state, src, tgt, 32)
    host = _seq2seq_small(torch.device("cpu"), state, src, tgt, 32)
    x = torch.from_numpy(rng.standard_normal((2, 32, 128))
                         .astype(np.float32))
    f_state = {k: v.numpy() for k, v in FusedMultiTransformer(
        **FUSED_SMALL, device="cpu", generator=Generator(13))
        .state_dict().items()}
    f_card = _fused_small(dev, f_state, x)
    f_host = _fused_small(torch.device("cpu"), f_state, x)
    out = {"seq2seq_out_max_diff": float((card[0] - host[0]).abs().max()),
           "seq2seq_decode_vs_forward_card": card[1],
           "seq2seq_decode_vs_forward_cpu": host[1],
           "fused_out_max_diff": float((f_card[0] - f_host[0]).abs().max()),
           "fused_decode_vs_forward_card": f_card[1],
           "fused_decode_vs_forward_cpu": f_host[1]}
    out["decoders_ok"] = (
        out["seq2seq_out_max_diff"] <= REF_ATOL
        and out["fused_out_max_diff"] <= REF_ATOL
        and max(card[1], host[1], f_card[1], f_host[1]) <= DECODE_ATOL)
    return out


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


# the reference phase's small f32 MoE: head_dim 64 and kv groups of 2 at
# S = 256 (the grouped flash kernels on the card, their plain versions on
# the CPU), 8 routed experts and one shared expert, 2 layers
MOE_SMALL = dict(vocab_size=256, hidden_size=256, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, num_experts=8, moe_every=1,
                 num_shared_experts=1)
# gate -> (top_k, gate class swapped in or None); "top1" runs in eval mode
# (no router noise), the rest in training mode, as the factory runs them:
# "top1_train" with N(0, 0.01^2) noise on the router logits
MOE_GATES = {"top1": (1, None), "top1_train": (1, None), "top2": (2, None),
             "top4": (4, None), "expert_choice": (2, "ExpertChoiceGate")}
# the seed of the top-1 router noise's generator on the card
MOE_NOISE_SEED = 17


@contextlib.contextmanager
def _noise_of_the_card(dev):
    """The port's top-1 router noise, whatever the logits' device, drawn
    from one generator of the card seeded with ``MOE_NOISE_SEED`` and
    copied to the logits' device: a CPU run takes the draws a card run
    takes, in the same order."""
    from paddle_tpu_torch.incubate.distributed.models import moe

    own = moe._noised
    card = torch.Generator(device=dev).manual_seed(MOE_NOISE_SEED)

    def noised(logits, generator, eps_std):
        if generator is None or eps_std <= 0:
            return logits
        return own(logits.to(dev), card, eps_std).to(logits.device)

    moe._noised = noised
    try:
        yield
    finally:
        moe._noised = own


def _moe_model(dev, state, cfg, gate):
    """The small MoE on ``dev`` from ``state``, with ``gate``'s routing:
    the config's own gate or an ``ExpertChoiceGate`` holding the same
    router weight; "top1" in eval mode; the router noise from a generator
    seeded with ``MOE_NOISE_SEED``."""
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.models.nlp import (MoEForCausalLM,
                                             load_numpy_state_dict)

    noise = torch.Generator(device=dev)
    model = MoEForCausalLM(cfg, device=dev, generator=noise)
    cls = MOE_GATES[gate][1]
    if cls is not None:
        for layer in model.layers:
            if layer.use_moe:
                layer.mlp.gate = getattr(moe, cls)(cfg.hidden_size,
                                                   cfg.num_experts,
                                                   device=dev)
    load_numpy_state_dict(model, state)
    noise.manual_seed(MOE_NOISE_SEED)    # after the experts' init drew
    return model.train(gate != "top1")


def _moe_small(dev, state, cfg, gate, tokens, labels):
    """The small MoE on ``dev``: its logits and aux loss, then the
    factory's first gradients, 3 steps' losses and the parameters after
    them (``_train_small``'s tuple), each on the CPU."""
    from paddle_tpu_torch.models.nlp import moe_train_step_factory
    from paddle_tpu_torch.models.nlp.moe import moe_loss

    model = _moe_model(dev, state, cfg, gate)
    tokens, labels = tokens.to(dev), labels.to(dev)
    with torch.no_grad():
        logits = model(tokens).cpu()
        aux = float(model.aux_loss())
    params, opt, step = moe_train_step_factory(
        model, learning_rate=TRAIN_REF["lr"], device=dev)
    loss = moe_loss(model, tokens, labels)
    grads = {k: g.cpu() for k, g in
             zip(params, torch.autograd.grad(loss, list(params.values())))}
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, tokens, labels)
        losses.append(float(loss))
    return logits, aux, (losses, grads, {k: p.detach().cpu()
                                         for k, p in params.items()}, False)


def _reference_moe(dev):
    """The small f32 MoE (``MOE_SMALL``) on the card and on the CPU from the
    same weights, for each dispatch mode and gate: logits and aux within
    ``REF_ATOL``, then 3 steps of ``moe_train_step_factory`` under
    ``TRAIN_REF``. Returns (its readings, ok)."""
    from paddle_tpu_torch.models.nlp import MoEConfig, MoEForCausalLM

    rng = np.random.default_rng(15)
    tokens, labels = (torch.from_numpy(rng.integers(0, 256, (2, 256)))
                      for _ in range(2))
    cases, ok = {}, True
    for mode in ("indexed", "inverted", "einsum"):
        for gate, (top_k, _) in MOE_GATES.items():
            cfg = MoEConfig(**MOE_SMALL, top_k=top_k, dispatch_mode=mode)
            state = {k: v.numpy() for k, v in MoEForCausalLM(
                cfg, device="cpu", seed=16).state_dict().items()}
            card = _moe_small(dev, state, cfg, gate, tokens, labels)
            with _noise_of_the_card(dev):
                cpu = _moe_small(torch.device("cpu"), state, cfg, gate,
                                 tokens, labels)
            diff = float((card[0] - cpu[0]).abs().max())
            aux_diff = abs(card[1] - cpu[1])
            train, train_ok = _train_agree(card[2], cpu[2])
            case_ok = diff <= REF_ATOL and aux_diff <= REF_ATOL and train_ok
            cases[f"{mode}/{gate}"] = {
                "max_logit_diff": diff, "aux_card": card[1],
                "aux_cpu": cpu[1], "aux_diff": aux_diff, **train,
                "ok": case_ok}
            ok = ok and case_ok
    return ({"config": MOE_SMALL, "S": 256, "atol": REF_ATOL,
             "cases": cases, "ok": ok}, ok)


# the reference phase's engine check: a small f32 Llama at head_dim 64 (the
# paged kernel's smallest) behind the serving factory, page 16, 4 slots
ENGINE_SMALL = dict(vocab=97, hidden=256, layers=2, heads=4, kv_heads=2,
                    max_len=64, page_size=16, slots=4)


def _engine_small_trace():
    """The mixed trace of the reference engine test: Poisson singles with
    churn, merged with one uniform burst."""
    from paddle_tpu_torch.serving import merge_traces, synthesize_trace

    ragged = synthesize_trace(seed=3, n_requests=5, arrival="poisson",
                              mean_interarrival=0.5, prompt_len=(4, 14),
                              output_len=(3, 6), vocab_size=97,
                              churn_frac=0.3, rid_prefix="r")
    burst = synthesize_trace(seed=9, n_requests=4, arrival="bursty",
                             burst_size=4, mean_interarrival=0.7,
                             prompt_len=(8, 12), output_len=(3, 5),
                             vocab_size=97, rid_prefix="b")
    return merge_traces(ragged, burst)


def _reference_engine(dev):
    """``ServingEngine`` on the fixed clock over the serving factory of a
    small f32 Llama, on the card and on the CPU, under the routed, dense
    and paged policies: outputs identical across devices and policies,
    slot logs and reports identical across devices, both backends
    exercised, the paged kernel launched on the card only. Returns (its
    readings, ok)."""
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_serving_decode_factory,
                                             load_numpy_state_dict)
    from paddle_tpu_torch.ops import paged_attention
    from paddle_tpu_torch.serving import ServingEngine

    e = ENGINE_SMALL
    cfg = LlamaConfig.tiny(vocab=e["vocab"], hidden=e["hidden"],
                           layers=e["layers"], heads=e["heads"],
                           kv_heads=e["kv_heads"])
    state = {k: v.numpy() for k, v in
             LlamaForCausalLM(cfg, device="cpu", seed=15).state_dict()
             .items()}
    trace = _engine_small_trace()
    runs, launches, int8_pools = {}, {}, {}
    for d in (dev, torch.device("cpu")):
        model = load_numpy_state_dict(LlamaForCausalLM(cfg, device=d), state)
        srv = llama_serving_decode_factory(
            model, max_len=e["max_len"], page_size=e["page_size"],
            n_pool_pages=e["slots"] * (e["max_len"] // e["page_size"]) + 1,
            batch_capacity=e["slots"], chunked_prefill=e["page_size"],
            device=d)
        paged_attention.launches = 0
        for pol in ("routed", "dense", "paged"):
            res = ServingEngine(serving=srv, slots=e["slots"], policy=pol,
                                clock="fixed").run(trace)
            runs[d.type, pol] = res
        launches[d.type] = paged_attention.launches
        # int8 pages and dense caches, through the constructor's model
        # path (greedy tokens may differ from full precision, not
        # between card and CPU)
        eng = ServingEngine(
            model, slots=e["slots"], max_len=e["max_len"],
            page_size=e["page_size"], policy="routed", clock="fixed",
            kv_quant="int8", device=d)
        runs[d.type, "int8"] = eng.run(trace)
        int8_pools[d.type] = (str(eng._pools[0][0].dtype),
                              eng.pool_bytes_per_device())
    want = {r.rid: min(r.max_new_tokens, r.cancel_after or 10 ** 9)
            for r in trace}
    outs = {k: r.outputs for k, r in runs.items()}
    same_outputs = all(o == outs["cpu", "paged"] for k, o in outs.items()
                       if k[1] != "int8")
    same_logs = all(runs[dev.type, p].outputs == runs["cpu", p].outputs
                    and runs[dev.type, p].slot_log == runs["cpu", p].slot_log
                    and runs[dev.type, p].report()
                    == runs["cpu", p].report()
                    for p in ("routed", "dense", "paged", "int8"))
    int8_ok = (int8_pools[dev.type] == int8_pools["cpu"]
               and int8_pools["cpu"][0] == "torch.int8")
    backends = {p: sorted({d["backend"] for d in runs[dev.type, p]
                           .decisions}) for p in ("routed", "dense",
                                                  "paged")}
    streams = all(len(o[rid]) == n for o in outs.values()
                  for rid, n in want.items())
    ok = (same_outputs and same_logs and streams and int8_ok
          and backends["dense"] == ["dense"]
          and backends["paged"] == ["paged"]
          and launches[dev.type] > 0 and launches["cpu"] == 0)
    return ({"config": {k: e[k] for k in ("hidden", "heads", "kv_heads",
                                          "layers", "page_size", "slots")},
             "requests": len(trace), "outputs_identical": same_outputs,
             "slot_logs_and_reports_identical": same_logs,
             "streams_full": streams, "backends": backends,
             "int8_pools": int8_pools[dev.type],
             "paged_launches_card": launches[dev.type],
             "paged_launches_cpu": launches["cpu"], "ok": ok}, ok)


# the reference phase's feature checks: the ENGINE_SMALL model, an
# independent seeded draft at head_dim 64, two JSON schemas (one required
# property each: an acyclic automaton, at most 12 tokens to its accept)
FEATURE_DRAFT = dict(vocab=97, hidden=128, layers=1, heads=2, kv_heads=1)
FEATURE_SCHEMAS = {
    "s0": {"type": "object", "properties": {"k0": {"type": "boolean"}},
           "required": ["k0"]},
    "s1": {"type": "object",
           "properties": {"k1": {"type": "integer", "maxDigits": 3}},
           "required": ["k1"]}}


def _feature_small_traces():
    """One small trace a feature (vocab 97, footprints within max_len 64,
    the spec slack of n_draft + 1 included)."""
    from paddle_tpu_torch.serving import (synthesize_schema_trace,
                                          synthesize_trace,
                                          synthesize_zipf_adapter_trace)

    spec = synthesize_trace(seed=0, n_requests=8, mean_interarrival=0.5,
                            prompt_len=(4, 30), output_len=(4, 12),
                            vocab_size=97, churn_frac=0.2, rid_prefix="q")
    return {
        "lora": synthesize_zipf_adapter_trace(
            seed=1, n_requests=10, n_adapters=3, base_frac=0.3,
            churn_frac=0.0, prompt_len=(5, 30), output_len=(3, 8),
            vocab_size=97),
        "grammar": synthesize_schema_trace(
            seed=4, n_requests=8, n_schemas=2, prompt_len=(4, 20),
            output_len=(16, 24), vocab_size=97),
        "spec": spec, "spec_twin": spec,
        "ragged": synthesize_trace(
            seed=5, n_requests=8, mean_interarrival=2.0, prompt_len=(4, 40),
            output_len=(3, 8), vocab_size=97, shared_prefix_frac=0.25)}


def _reference_features(dev):
    """The serving engine's options on the fixed clock over the
    ENGINE_SMALL model's serving factory, on the card and on the CPU: a
    LoRA engine (``lora=(4, 4)``, 3 adapters), a grammar engine (2
    schemas), a spec engine with an independent draft and with the target's
    own weights as a perfect draft, and the ragged lane
    (``prefill_chunk_budget=2``). Card against CPU: identical outputs and
    slot logs. Feature against no feature on the same device: the LoRA
    engine's adapter-free rows, the spec engines' streams and the ragged
    lane's equal the plain engine's (the lane's with
    ``ragged_prefill=False``); every constrained stream parses under its
    schema; the perfect draft accepts at least 99 % of its proposals.
    Returns (its readings, ok)."""
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_serving_decode_factory,
                                             load_numpy_state_dict)
    from paddle_tpu_torch.serving import (AdapterStore, GrammarStore,
                                          ServingEngine, SpecConfig,
                                          TokenVocab, schema_accepts,
                                          synthesize_lora_deltas)

    e = ENGINE_SMALL
    cfg = LlamaConfig.tiny(vocab=e["vocab"], hidden=e["hidden"],
                           layers=e["layers"], heads=e["heads"],
                           kv_heads=e["kv_heads"])
    dcfg = LlamaConfig.tiny(**FEATURE_DRAFT)
    state = {k: v.numpy() for k, v in
             LlamaForCausalLM(cfg, device="cpu", seed=15).state_dict()
             .items()}
    dstate = {k: v.numpy() for k, v in
              LlamaForCausalLM(dcfg, device="cpu", seed=16).state_dict()
              .items()}
    traces = _feature_small_traces()
    adapters = AdapterStore({f"a{k}": synthesize_lora_deltas(
        cfg, 4, seed=k + 1, init_scale=0.25) for k in range(3)})
    n_pages = e["slots"] * (e["max_len"] // e["page_size"]) + 1
    runs, plain = {}, {}
    for d in (dev, torch.device("cpu")):
        def load(c, s):
            return load_numpy_state_dict(LlamaForCausalLM(c, device=d), s)

        def factory(**kw):
            return llama_serving_decode_factory(
                load(cfg, state), max_len=e["max_len"],
                page_size=e["page_size"], n_pool_pages=n_pages,
                batch_capacity=e["slots"], chunked_prefill=e["page_size"],
                device=d, **kw)

        def serve(srv, trace, **kw):
            return ServingEngine(serving=srv, slots=e["slots"],
                                 policy="paged", clock="fixed",
                                 **kw).run(trace)

        base = factory()
        lane = dict(prefill_chunk_budget=2)
        for f, trace in traces.items():
            if f in ("lora", "grammar"):
                trace = [dataclasses.replace(r, adapter=None, schema=None)
                         for r in trace]
            plain[d.type, f] = serve(base, trace,
                                     **(lane if f == "ragged" else {}))
        runs[d.type, "lora"] = serve(factory(lora=(4, 4)), traces["lora"],
                                     adapters=adapters)
        runs[d.type, "grammar"] = serve(
            factory(grammar=(3, 64)), traces["grammar"],
            grammar=GrammarStore(FEATURE_SCHEMAS))
        runs[d.type, "spec"] = serve(
            factory(draft=load(dcfg, dstate)), traces["spec"],
            spec=SpecConfig(n_draft=3, accept_floor=0.0))
        runs[d.type, "spec_twin"] = serve(
            factory(draft=load(cfg, state)), traces["spec_twin"],
            spec=SpecConfig(n_draft=3))
        runs[d.type, "ragged"] = serve(base, traces["ragged"],
                                       ragged_prefill=True, **lane)
    vocab = TokenVocab.ascii_default(e["vocab"])
    out = {}
    for f, trace in traces.items():
        card, cpu = runs[dev.type, f], runs["cpu", f]
        same = card.outputs == cpu.outputs and card.slot_log == cpu.slot_log
        if f == "lora":
            rows = [r.rid for r in trace if r.adapter is None]
        elif f == "grammar":
            rows = [r.rid for r in trace if r.schema is None]
        else:
            rows = [r.rid for r in trace]
        as_plain = all(card.outputs[rid] == plain[dev.type, f].outputs[rid]
                       and cpu.outputs[rid] == plain["cpu", f].outputs[rid]
                       for rid in rows)
        o = {"requests": len(trace), "card_equals_cpu": same,
             "equals_plain": as_plain, "rows_compared": len(rows)}
        ok = same and as_plain and len(card.outputs) == len(trace)
        if f == "lora":
            o["adapter_stats"] = card.adapter_stats
            o["adapted_streams_differ"] = sum(
                card.outputs[r.rid] != plain[dev.type, f].outputs[r.rid]
                for r in trace if r.adapter is not None)
            ok = ok and card.adapter_stats["invariant_ok"]
        if f == "grammar":
            parsed = [schema_accepts(FEATURE_SCHEMAS[r.schema],
                                     vocab.decode(card.outputs[r.rid]))
                      for r in trace if r.schema is not None]
            o.update(constrained=len(parsed), parsed=sum(parsed),
                     grammar_stats=card.grammar_stats)
            ok = ok and all(parsed) and bool(parsed) \
                and card.grammar_stats["invariant_ok"]
        if f.startswith("spec"):
            st = card.spec_stats
            o.update(rounds=st["rounds"],
                     acceptance_rate=st["acceptance_rate"])
            ok = ok and st["rounds"] > 0 and (
                f == "spec" or st["acceptance_rate"] >= 0.99)
        o["ok"] = ok
        out[f] = o
    return out, all(o["ok"] for o in out.values())



def _engine_small_state():
    """ENGINE_SMALL's config and seeded f32 weights (as numpy)."""
    from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM

    e = ENGINE_SMALL
    cfg = LlamaConfig.tiny(vocab=e["vocab"], hidden=e["hidden"],
                           layers=e["layers"], heads=e["heads"],
                           kv_heads=e["kv_heads"])
    return cfg, {k: v.numpy() for k, v in
                 LlamaForCausalLM(cfg, device="cpu", seed=15).state_dict()
                 .items()}


def _tiers_small_trace():
    """Two-turn sessions on ENGINE_SMALL's vocabulary (footprints within
    max_len 64) and one priority-9 request of another tenant."""
    from paddle_tpu_torch.serving import (Request, merge_traces,
                                          synthesize_session_trace)

    sessions = synthesize_session_trace(
        seed=0, n_sessions=4, turns=2, think_time=30.0,
        first_prompt_len=(16, 24), turn_prompt_len=(4, 8),
        output_len=(6, 10), vocab_size=97, mean_interarrival=1.0)
    return merge_traces(sessions, [Request(
        rid="hi0", prompt=tuple(range(40, 60)), max_new_tokens=6,
        arrival=4.0, priority=9, tenant="t1")])


TIERS_SMALL = {
    # a pool of 17 pages under a budget of 8 full-precision pages, a QoS
    # scheduler: budget-driven compaction
    "pressure": (dict(n_pool_pages=17, kv_quant="pressure"),
                 dict(kv_quant_budget=8, scheduler="qos")),
    # a pool of 9 pages (8 usable) and a 1 MiB arena: spills, page-ins and
    # the preempt rung
    "hostmem": (dict(n_pool_pages=9),
                dict(hostmem=1 << 20, scheduler="qos")),
    # the lane and decode chunks of 2, dispatch-ahead on
    "ahead": (dict(n_pool_pages=17),
              dict(dispatch_ahead=True, prefill_chunk_budget=1,
                   ragged_prefill=True, decode_chunk=2)),
}


def _reference_tiers(dev, parts=tuple(TIERS_SMALL)):
    """The pressure, host-memory and dispatch-ahead engines on the fixed
    clock over ENGINE_SMALL's serving factory, on the card and on the
    CPU: the same outputs, slot logs, censuses and tier stats; each tier
    actually moved pages (compactions; spills, page-ins, a preemption);
    the host arena held only pinned host tensors; dispatch-ahead equals
    the flag-off engine and served turns from its stash. Returns (its
    readings, ok)."""
    from paddle_tpu_torch.models.nlp import (LlamaForCausalLM,
                                             llama_serving_decode_factory,
                                             load_numpy_state_dict)
    from paddle_tpu_torch.obs import Tracer
    from paddle_tpu_torch.serving import QoSScheduler, ServingEngine

    e = ENGINE_SMALL
    cfg, state = _engine_small_state()
    out, ok = {}, True
    for part in parts:
        fac_kw, eng_kw = TIERS_SMALL[part]
        trace = _tiers_small_trace() if part != "ahead" \
            else _engine_small_trace()
        runs = {}
        for d in (dev, torch.device("cpu")):
            model = load_numpy_state_dict(LlamaForCausalLM(cfg, device=d),
                                          state)
            srv = llama_serving_decode_factory(
                model, max_len=e["max_len"], page_size=e["page_size"],
                batch_capacity=e["slots"], chunked_prefill=e["page_size"],
                device=d, **fac_kw)
            kw = dict(eng_kw)
            if "kv_quant_budget" in kw:
                kw["kv_quant_budget"] *= srv.page_bytes_[0]
            if kw.get("scheduler") == "qos":
                kw["scheduler"] = QoSScheduler()
            tracer = Tracer()
            with _Watch() as w:
                runs[d.type] = (ServingEngine(
                    serving=srv, slots=e["slots"], policy="paged",
                    clock="fixed", trace=tracer, **kw).run(trace), w,
                    tracer)
            if part == "ahead":
                runs[d.type, "off"] = ServingEngine(
                    serving=srv, slots=e["slots"], policy="paged",
                    clock="fixed",
                    **{**kw, "dispatch_ahead": False}).run(trace)
        (got, w, tracer), (want, _, _) = runs[dev.type], runs["cpu"]
        same = (got.outputs == want.outputs
                and got.slot_log == want.slot_log
                and got.cache_stats == want.cache_stats
                and got.kv_quant_stats == want.kv_quant_stats
                and got.hostmem_stats == want.hostmem_stats
                and got.report() == want.report())
        r = {"requests": len(trace), "identical": same}
        if part == "pressure":
            r["kv_quant_stats"] = got.kv_quant_stats
            moved = got.kv_quant_stats["compactions"] > 0
        elif part == "hostmem":
            hs = got.hostmem_stats
            r["hostmem"] = {k: hs[k] for k in ("spills", "pageins",
                                                "preempts", "restores")}
            r["arena_tensors"] = w.arena
            moved = (hs["spills"] > 0 and hs["pageins"] > 0
                     and hs["preempts"] > 0 and hs["restores"] > 0
                     and w.arena["tensors"] > 0
                     and w.arena["pinned"] == w.arena["tensors"]
                     and w.arena["on_card"] == 0)
        else:
            served = sum(1 for s in _engine_spans(tracer.events, "decode")
                         if s["args"].get("ahead"))
            r["served_from_stash"] = served
            moved = (served > 0
                     and got.outputs == runs[dev.type, "off"].outputs
                     and got.slot_log == runs[dev.type, "off"].slot_log)
        r["ok"] = same and moved
        ok = ok and r["ok"]
        out[part] = r
    return out, ok


def _decode_small_pair(seed, window=None, tie=False, **tiny):
    """A tiny f32 Llama's state, made on the CPU from ``seed``."""
    from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM

    cfg = dataclasses.replace(LlamaConfig.tiny(**tiny),
                              sliding_window=window, tie_word_embeddings=tie)
    return cfg, {k: v.numpy() for k, v in LlamaForCausalLM(
        cfg, device="cpu", seed=seed).state_dict().items()}


DECODE_SMALL = {
    # hidden 256, 4 / 2 heads (head_dim 64): int8 weights and KV cache
    "int8": dict(seed=21, tiny=dict(vocab=97, hidden=256, layers=2, heads=4,
                                    kv_heads=2),
                 factory=dict(max_len=32, weight_dtype="int8",
                              kv_cache_dtype="int8"), B=2, S0=9, new=8),
    # window 8 under max_len 16, a 12-token prompt: the rolled prefill
    "rolling": dict(seed=22, window=8,
                    tiny=dict(vocab=97, hidden=128, layers=2, heads=2,
                              kv_heads=2),
                    factory=dict(max_len=16), B=2, S0=12, new=10),
}


def _reference_decode_options(dev, parts=("int8", "rolling", "spec")):
    """The dense decode options on small f32 models, on the card and on
    the CPU from the same weights: int8 weights (with the int8 cache) and
    the rolling cache give the same greedy tokens and teacher-forced
    logits within REF_ATOL; the speculative factory (a hidden-256 target,
    a 1-layer draft) gives the same tokens and stats, equal to plain
    greedy. Returns (its readings, ok)."""
    from paddle_tpu_torch.models.nlp import (LlamaForCausalLM,
                                             llama_decode_factory,
                                             llama_speculative_decode_factory,
                                             load_numpy_state_dict)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out, ok = {}, True
    for part in parts:
        if part == "spec":
            tcfg, tstate = _decode_small_pair(
                23, vocab=97, hidden=256, layers=3, heads=4, kv_heads=2)
            dcfg, dstate = _decode_small_pair(
                24, vocab=97, hidden=128, layers=1, heads=2, kv_heads=1)
            prompt = np.random.default_rng(3).integers(0, 97, (1, 6))
            res = {}
            for d in (dev, torch.device("cpu")):
                t = load_numpy_state_dict(LlamaForCausalLM(tcfg, device=d),
                                          tstate)
                dr = load_numpy_state_dict(LlamaForCausalLM(dcfg, device=d),
                                           dstate)
                spec = llama_speculative_decode_factory(t, dr, max_len=64,
                                                        n_draft=4, device=d)
                res[d.type] = (spec(prompt, 24), spec.compiled(prompt, 24),
                               spec.last_stats, spec.compiled.last_stats,
                               llama_decode_factory(t, max_len=64, device=d)
                               .compiled(prompt, 24))
            g, c = res[dev.type], res["cpu"]
            same = all(np.array_equal(a, b) for a, b in
                       zip(g[:2] + g[4:], c[:2] + c[4:]))
            r = {"identical": same and g[2:4] == c[2:4],
                 "equal_to_greedy": bool(np.array_equal(g[1], g[4])
                                         and np.array_equal(g[0], g[4])),
                 "stats": g[3]}
            r["ok"] = r["identical"] and r["equal_to_greedy"]
        else:
            p = DECODE_SMALL[part]
            cfg, state = _decode_small_pair(p["seed"], p.get("window"),
                                            **p["tiny"])
            prompts = np.random.default_rng(4).integers(
                1, 97, (p["B"], p["S0"]))
            res = {}
            for d in (dev, torch.device("cpu")):
                gen = llama_decode_factory(
                    load_numpy_state_dict(LlamaForCausalLM(cfg, device=d),
                                          state), device=d, **p["factory"])
                toks = gen.compiled(prompts, p["new"])
                res[d.type] = (toks, _teacher(gen, torch.as_tensor(
                    toks, device=d), p["S0"])[0])
            (gt, gl), (ct, cl) = res[dev.type], res["cpu"]
            err = float((gl.cpu() - cl).abs().max())
            r = {"tokens_identical": bool(np.array_equal(gt, ct)),
                 "logits_max_abs_err": err}
            r["ok"] = r["tokens_identical"] and err <= REF_ATOL
        ok = ok and r["ok"]
        out[part] = r
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return out, ok


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
    engine, engine_ok = _reference_engine(dev)
    features, features_ok = _reference_features(dev)
    tiers, tiers_ok = _reference_tiers(dev)
    decode_options, decode_options_ok = _reference_decode_options(dev)
    enc = _reference_encoder(dev)
    bert = _reference_bert(dev)
    vision = _reference_vision(dev)
    moe, moe_ok = _reference_moe(dev)
    gpt = _reference_gpt(dev)
    decoders = _reference_decoders(dev)
    ops_rnn, ops_rnn_ok = _reference_ops_and_rnn(dev)
    out.update({"ops_and_rnn": ops_rnn,
                "llama_d256_g3": {**wide, "ok": wide_ok},
                "llama_options": options, "engine": engine,
                "engine_features": features, "engine_tiers": tiers,
                "decode_options": decode_options, **enc, **bert,
                "vision": vision, "moe": moe, **gpt, **decoders,
                "ok": ok and wide_ok and options_ok and engine_ok
                and features_ok and tiers_ok and decode_options_ok
                and enc["encoder_ok"] and bert["bert_ok"]
                and vision["ok"] and moe_ok and gpt["gpt_ok"]
                and decoders["decoders_ok"] and ops_rnn_ok})
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


# the hand loop's depth: serve_engine serves all 32 layers, and the whole
# script keeps near its earlier wall time with this phase cut to 8
SERVE_LAYERS = 8


def phase_serve(dev, profile=False):
    from paddle_tpu_torch.examples.serve_paged_llama import serve
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_decode,
                                             llama_paged_decode_factory)
    from paddle_tpu_torch.ops import (PagedKVCache, paged_attention,
                                      paged_attention_reference)

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=SERVE_LAYERS)
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
           "cut": f"{L} of 32 layers (serve_engine serves all 32)",
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


# --- phase 5: serve Llama-3-8B through ServingEngine ----------------------

# the serving factory and engine of the serve_engine phase: 8 slots of 2048
# tokens, pages of 64, a pool of 8 x 32 pages + the reserved page 0,
# chunked prefill of one page (the engine's own build), dense capacity 8
SERVE_ENGINE = dict(max_len=2048, page_size=64, slots=8, chunked_prefill=64,
                    replay=12)
# the Poisson part's mean interarrival, virtual seconds: about one paged
# decode turn of the measured run (medians of 28.4-36.5 ms on one H100
# 80GB HBM3 at 700 W; PERF.md §4)
ENGINE_INTERARRIVAL = 0.03


def _serve_engine_trace(vocab):
    """32 requests: one uniform burst of 8 (prompts 256-512, 32-64 new
    tokens) that arrives alone, then 24 Poisson singles from its arrival
    on (prompts 128-1024, 32-128 new tokens, half opening with one of two
    256-token prefixes, a fifth cancelled early)."""
    from paddle_tpu_torch.serving import merge_traces, synthesize_trace

    burst = synthesize_trace(seed=1, n_requests=8, arrival="bursty",
                             burst_size=8, prompt_len=(256, 512),
                             output_len=(32, 64), vocab_size=vocab,
                             rid_prefix="b")
    singles = synthesize_trace(seed=0, n_requests=24, arrival="poisson",
                               mean_interarrival=ENGINE_INTERARRIVAL,
                               prompt_len=(128, 1024), output_len=(32, 128),
                               vocab_size=vocab, shared_prefix_frac=0.5,
                               prefix_len=256, n_prefix_groups=2,
                               churn_frac=0.2, start=burst[0].arrival)
    return merge_traces(burst, singles)


def _engine_spans(events, name):
    return [e for e in events if e["ph"] == "X" and e["name"] == name]


def phase_serve_engine(dev):
    """Llama-3-8B, full width and depth, bf16, seeded weights, through
    ``llama_serving_decode_factory`` and ``ServingEngine(policy="routed",
    clock="measured")`` on ``_serve_engine_trace``. First a fixed-clock
    replay of the first 12 requests, twice (identical outputs and slot
    logs; it also warms the card up). Then the paged kernel's counts are
    set to 0, the measured run serves the 32 requests, and the counts are
    read: every launch must be a paged decode step's (``split``, 32 a
    step); prefill chunks attend by the plain page gather and the dense
    wave in plain PyTorch, as in the reference."""
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_serving_decode_factory)
    from paddle_tpu_torch.obs import Tracer
    from paddle_tpu_torch.serving import ServingEngine

    e = SERVE_ENGINE
    cfg = LlamaConfig.llama3_8b()
    L = cfg.num_hidden_layers
    ps, C = e["page_size"], e["chunked_prefill"]
    n_pages = e["slots"] * (e["max_len"] // ps) + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    srv = llama_serving_decode_factory(
        model, max_len=e["max_len"], page_size=ps, n_pool_pages=n_pages,
        batch_capacity=e["slots"], chunked_prefill=C)
    del model                      # the factory holds the stacked copy
    gc.collect()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    trace = _serve_engine_trace(cfg.vocab_size)

    def engine(clock, tracer=None):
        return ServingEngine(serving=srv, slots=e["slots"], policy="routed",
                             clock=clock, expect_churn=False, trace=tracer)

    # fixed clock: the first requests by arrival, twice
    first = sorted(trace, key=lambda r: (r.arrival, r.rid))[:e["replay"]]
    replays = [engine("fixed").run(first) for _ in range(2)]
    replay_ok = (replays[0].outputs == replays[1].outputs
                 and replays[0].slot_log == replays[1].slot_log
                 and len(replays[0].outputs) == len(first))
    replay_backends = sorted({d["backend"] for d in replays[0].decisions})
    del replays

    tracer = Tracer()
    _zero_paged_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = engine("measured", tracer).run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, launched_by = _paged_counts()

    events = tracer.events
    decode = _engine_spans(events, "decode")
    steps = sum(s["args"].get("n", 1) for s in decode)
    want_by = {"split": L * steps, "mma": 0, "rows": 0}
    prompts = {r.rid: len(r.prompt) for r in trace}
    chunk_ms = []
    for s in _engine_spans(events, "prefill"):
        T = max(C, -(-prompts[s["args"]["rid"]] // C) * C)
        chunks = (T - min(s["args"].get("resume", 0), T - C)) // C
        chunk_ms.append(1e3 * s["dur"] / chunks)
    dense_steps = _engine_spans(events, "dense_decode")
    want = {r.rid: min(r.max_new_tokens, r.cancel_after or 10 ** 9)
            for r in trace}
    got = {rid: len(out) for rid, out in res.outputs.items()}
    streams_ok = got == want and all(
        0 <= tok < cfg.vocab_size for out in res.outputs.values()
        for tok in out)
    cs = res.cache_stats
    census_ok = (cs["resident_pages"] + cs["evictable_pages"]
                 + cs["free_pages"] == cs["n_pages"] == n_pages - 1
                 and cs["invariant_ok"])
    by_backend = {}
    for d in res.decisions:
        b = by_backend.setdefault(d["backend"], {"waves": 0, "requests": 0,
                                                 "rules": {}})
        b["waves"] += 1
        b["requests"] += d["wave"]
        rule = d["rule"].split(" (")[0]
        b["rules"][rule] = b["rules"].get(rule, 0) + 1
    rep = res.report()
    generated = sum(got.values())
    out = {"phase": "serve_engine", "model": "llama3_8b", "layers": L,
           "dtype": "bfloat16", "requests": len(trace),
           "policy": "routed", "clock": "measured",
           "completed": rep["completed"], "cancelled": rep["evicted"],
           "generated_tokens": generated, "wall_s": wall,
           "tokens_per_s_wall": generated / wall, "setup_s": setup_s,
           "ttft_p50_s": rep["ttft_p50"], "ttft_p95_s": rep["ttft_p95"],
           "tpot_p50_s": rep["tpot_p50"],
           "decode_turns": len(decode), "decode_steps": steps,
           "decode_turn_ms_median": 1e3 * statistics.median(
               s["dur"] for s in decode) if decode else None,
           "prefill_calls": len(chunk_ms),
           "prefill_chunks": res.prefill_tokens // C,
           "prefill_chunk_ms_median": statistics.median(chunk_ms)
           if chunk_ms else None,
           "dense_decode_steps": len(dense_steps),
           "dense_decode_ms_median": 1e3 * statistics.median(
               s["dur"] for s in dense_steps) if dense_steps else None,
           "overhead": res.overhead,
           "engine_host_frac": (res.overhead or {}).get("engine_host_frac"),
           "routing": by_backend,
           "prefix_hit_tokens": cs["hit_tokens"],
           "prefix_lookup_tokens": cs["lookup_tokens"],
           "prefix_hit_requests": sum(1 for n in res.prefix_cached.values()
                                      if n),
           "cache_stats": cs,
           "launches": launches, "launches_expected": L * steps,
           "launches_by_instance": launched_by,
           "launches_by_instance_expected": want_by,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "streams_ok": streams_ok, "census_ok": census_ok,
           "replay": {"requests": len(first), "identical": replay_ok,
                      "backends": replay_backends},
           "interarrival_s": ENGINE_INTERARRIVAL}
    ok = (streams_ok and census_ok and replay_ok and steps > 0
          and launches == L * steps and launched_by == want_by
          and "dense" in by_backend and "paged" in by_backend)
    out["ok"] = ok
    del res, tracer, events, srv
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    if not ok:
        raise AssertionError("serve_engine phase failed: "
                             + json.dumps(out, default=str))
    return out


# --- phase 6: the serving engine's options, Llama-3-8B -------------------

# serve_features: the serve_engine phase's factory build, and each engine's
# options. The LoRA engine: a bank of 4 slots (3 adapters + the identity)
# at rank 16, a mask bank of 3 slots (2 schemas + the all-allow identity)
# of 64 states, the ragged lane with a budget of 256 dispatches a turn.
# The spec engine: a draft window of 3, no acceptance floor, its Poisson
# arrivals 0.1 virtual s apart on average (about one spec round, as
# serve_engine's are about one decode turn apart).
SERVE_FEATURES = dict(max_len=2048, page_size=64, slots=8, chunked_prefill=64,
                      lora=(4, 16), grammar=(3, 64), prefill_chunk_budget=256,
                      n_draft=3, replay=8, spread_s=1.0,
                      spec_interarrival=0.1, layers=16)
# the depth that keeps the whole script within its time limit: a paged
# turn is the host's loop over the layers, so a phase's wall time follows
# its depth; serve_engine and serve_tiers serve all 32
CUT = "16 of 32 decoder layers, full width: the whole script's time limit"


def _llama32_1b_draft():
    """The spec engine's draft: Llama-3.2-1B's widths (hidden 2048, 16
    layers, 32 / 8 heads, head_dim 64, FFN 8192, vocab 128256, tied
    embeddings, rope theta 500000), unfused. One cut: plain rope (its
    llama3 rope scaling is not in ``LlamaConfig``), as ``train_long``."""
    from paddle_tpu_torch.models.nlp import LlamaConfig

    return LlamaConfig(vocab_size=128256, hidden_size=2048,
                       intermediate_size=8192, num_hidden_layers=16,
                       num_attention_heads=32, num_key_value_heads=8,
                       max_position_embeddings=131072, rope_theta=500000.0,
                       tie_word_embeddings=True)


def _spread(trace, seconds):
    """``trace`` with its arrivals scaled to end at ``seconds``."""
    last = max(r.arrival for r in trace) or 1.0
    return [dataclasses.replace(r, arrival=r.arrival * seconds / last)
            for r in trace]


def _features_traces(vocab):
    """The LoRA engine's trace: 16 Zipf-adapter requests (3 adapters, a
    quarter base-model; prompts 128-512, 32-64 new tokens) merged with 8
    schema requests (2 schemas, a quarter free; prompts 64-256; seed 1,
    which draws both schemas: seed 0 draws one), each spread over
    ``spread_s``. The spec engine's: 16 Poisson requests (prompts
    128-512, 32-96 new tokens, a fifth cancelled early)."""
    from paddle_tpu_torch.serving import (merge_traces, synthesize_schema_trace,
                                          synthesize_trace,
                                          synthesize_zipf_adapter_trace)

    f = SERVE_FEATURES
    lora = synthesize_zipf_adapter_trace(
        seed=0, n_requests=16, n_adapters=3, base_frac=0.25,
        prompt_len=(128, 512), output_len=(32, 64), vocab_size=vocab)
    schema = synthesize_schema_trace(seed=1, n_requests=8, n_schemas=2,
                                     prompt_len=(64, 256), vocab_size=vocab)
    spec = synthesize_trace(seed=0, n_requests=16, arrival="poisson",
                            mean_interarrival=f["spec_interarrival"],
                            prompt_len=(128, 512), output_len=(32, 96),
                            vocab_size=vocab, churn_frac=0.2)
    return (merge_traces(_spread(lora, f["spread_s"]),
                         _spread(schema, f["spread_s"])), spec)


def _zero_paged_counts():
    from paddle_tpu_torch.ops import paged_attention

    paged_attention.launches = 0
    paged_attention.int8_launches = 0
    for name in paged_attention.instance_launches:
        paged_attention.instance_launches[name] = 0


def _paged_counts():
    from paddle_tpu_torch.ops import paged_attention

    return paged_attention.launches, dict(paged_attention.instance_launches)


def _median_ms(spans):
    return 1e3 * statistics.median(s["dur"] for s in spans) if spans \
        else None


def _features_run(name, make, trace, L, n_pages):
    """One engine of serve_features: a fixed-clock replay of the first
    ``replay`` requests twice, then the measured run of ``trace`` with the
    paged kernel's counts set to 0 just before and read just after.
    ``make(clock, tracer)`` builds the engine. Returns (readings, checks,
    the measured result)."""
    from paddle_tpu_torch.obs import Tracer

    f = SERVE_FEATURES
    first = sorted(trace, key=lambda r: (r.arrival, r.rid))[:f["replay"]]
    replays = [make("fixed", None).run(first) for _ in range(2)]
    replay_ok = (replays[0].outputs == replays[1].outputs
                 and replays[0].slot_log == replays[1].slot_log
                 and len(replays[0].outputs) == len(first))
    del replays
    tracer = Tracer()
    eng = make("measured", tracer)
    compile_ms = {}
    if eng._grammar_store is not None:
        # each schema's automaton compiled on the host once before the
        # run (the engine's memo): the run only uploads masks
        for g in eng._grammar_store.names():
            t0 = time.perf_counter()
            eng._grammar_automaton(g)
            compile_ms[g] = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_paged_counts()
    t0 = time.perf_counter()
    res = eng.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_instance = _paged_counts()
    events = tracer.events
    decode = _engine_spans(events, "decode")
    steps = sum(s["args"].get("n", 1) for s in decode)
    prefill = _engine_spans(events, "prefill")
    ragged = [s for s in prefill if "ragged" in s["args"]]
    spec = _engine_spans(events, "spec_decode")
    rep = res.report()
    got = {rid: len(out) for rid, out in res.outputs.items()}
    generated = sum(got.values())
    cs = res.cache_stats
    out = {"engine": name, "requests": len(trace),
           "completed": rep["completed"], "cancelled": rep["evicted"],
           "generated_tokens": generated, "wall_s": wall,
           "tokens_per_s_wall": generated / wall,
           "ttft_p50_s": rep["ttft_p50"], "ttft_p95_s": rep["ttft_p95"],
           "tpot_p50_s": rep["tpot_p50"],
           "decode_turns": len(decode), "decode_steps": steps,
           "decode_turn_ms_median": _median_ms(decode),
           "ragged_prefill_calls": len(ragged),
           "ragged_rows": sum(s["args"]["ragged"] for s in ragged),
           "ragged_prefill_ms_median": _median_ms(ragged),
           "prefill_calls": len(prefill) - len(ragged),
           "prefill_call_ms_median": _median_ms(
               [s for s in prefill if "ragged" not in s["args"]]),
           "spec_rounds_turns": len(spec),
           "spec_round_ms_median": _median_ms(spec),
           "spec_prefill_ms_median": _median_ms(
               _engine_spans(events, "spec_prefill")),
           "adapter_stats": res.adapter_stats,
           "grammar_stats": res.grammar_stats,
           "grammar_compile_host_ms": compile_ms or None,
           "spec_stats": res.spec_stats, "cache_stats": cs,
           "overhead": res.overhead,
           "launches": launches, "launches_by_instance": by_instance,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "replay": {"requests": len(first), "identical": replay_ok}}
    checks = {
        "replay_identical": replay_ok,
        "page_census": (cs["resident_pages"] + cs["evictable_pages"]
                        + cs["free_pages"] == cs["n_pages"] == n_pages - 1
                        and cs["invariant_ok"]),
        "launches_split_only": by_instance == {"split": L * steps,
                                               "mma": 0, "rows": 0}
        and launches == L * steps}
    return out, checks, res


def _spec_f32_control(dev, build, trace):
    """The spec engine's streams against a plain run's on the same
    factory, at full width in f32 (TF32 off) and 2 layers of target and
    draft (a cut of depth), on the fixed clock, over the first
    ``replay`` requests of the spec trace: the verify block's page gather
    and the ``split`` kernel then differ by f32 rounding, where bf16's
    flips near-tie argmaxes. Recorded, not held."""
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_serving_decode_factory)
    from paddle_tpu_torch.serving import ServingEngine, SpecConfig

    f = SERVE_FEATURES
    layers = 2
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=layers, dtype=torch.float32)
    dcfg = dataclasses.replace(_llama32_1b_draft(), num_hidden_layers=layers,
                               dtype=torch.float32)
    srv = llama_serving_decode_factory(
        LlamaForCausalLM(cfg, device=dev, seed=0),
        draft=LlamaForCausalLM(dcfg, device=dev, seed=1), **build)
    first = sorted(trace, key=lambda r: (r.arrival, r.rid))[:f["replay"]]

    def run(spec):
        return ServingEngine(serving=srv, slots=f["slots"], policy="paged",
                             clock="fixed", spec=spec).run(first)

    spec = run(SpecConfig(n_draft=f["n_draft"], accept_floor=0.0))
    plain = run(None)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    split = [next((i for i, (a, b) in enumerate(zip(
        spec.outputs[r.rid], plain.outputs[r.rid])) if a != b),
        len(spec.outputs[r.rid])) for r in first]
    out = {"dtype": "float32", "layers": layers,
           "cut": f"{layers} layers of target and draft",
           "equal": sum(spec.outputs[r.rid] == plain.outputs[r.rid]
                        for r in first), "of": len(first),
           "first_difference_at": split,
           "rounds": spec.spec_stats["rounds"],
           "acceptance_rate": spec.spec_stats["acceptance_rate"]}
    del srv, spec, plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_features(dev):
    """Llama-3-8B, full width, 16 of its 32 layers, bf16, seeded weights,
    through ``llama_serving_decode_factory`` and
    ``ServingEngine(policy="paged")`` with the options of ROADMAP item 11, two engines in
    turn, each freed before the next: multi-LoRA + grammar + the ragged
    lane, then speculative decoding with a Llama-3.2-1B-width draft. Each
    replays its first 8 requests twice on the fixed clock (identical),
    then serves its trace on the measured clock between a reset and a
    read of the paged kernel's counts; then the spec trace once more
    without spec, for the share of streams that agree, and the same
    comparison in f32 at 2 layers (``_spec_f32_control``)."""
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_serving_decode_factory)
    from paddle_tpu_torch.serving import (AdapterStore, GrammarConfig,
                                          GrammarStore, LoRAConfig,
                                          ServingEngine, SpecConfig,
                                          TokenVocab, schema_accepts,
                                          synthesize_lora_deltas)

    f = SERVE_FEATURES
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=f["layers"])
    L = cfg.num_hidden_layers
    n_pages = f["slots"] * (f["max_len"] // f["page_size"]) + 1
    build = dict(max_len=f["max_len"], page_size=f["page_size"],
                 n_pool_pages=n_pages, batch_capacity=f["slots"],
                 chunked_prefill=f["chunked_prefill"], device=dev)
    mixed, spec_trace = _features_traces(cfg.vocab_size)
    vocab = TokenVocab.ascii_default(cfg.vocab_size)
    out = {"phase": "serve_features", "model": "llama3_8b", "layers": L,
           "cut": CUT, "dtype": "bfloat16", "policy": "paged",
           "clock": "measured"}

    # 1. multi-LoRA + grammar + the ragged lane
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    srv = llama_serving_decode_factory(
        model, lora=LoRAConfig(*f["lora"]),
        grammar=GrammarConfig(*f["grammar"]), **build)
    del model
    adapters = AdapterStore({f"a{i}": synthesize_lora_deltas(
        cfg, f["lora"][1], seed=i) for i in range(3)})
    grammar = GrammarStore(FEATURE_SCHEMAS)
    gc.collect()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def lora_engine(clock, tracer):
        return ServingEngine(serving=srv, slots=f["slots"], policy="paged",
                             clock=clock, trace=tracer, adapters=adapters,
                             grammar=grammar, ragged_prefill=True,
                             prefill_chunk_budget=f["prefill_chunk_budget"])

    lo, lo_checks, res = _features_run("lora_grammar_ragged", lora_engine,
                                       mixed, L, n_pages)
    lo["setup_s"] = setup_s
    streams, parsed = True, []
    for r in mixed:
        toks = res.outputs[r.rid]
        if r.schema is not None:
            parsed.append(schema_accepts(FEATURE_SCHEMAS[r.schema],
                                         vocab.decode(toks)))
            streams &= 1 <= len(toks) <= r.max_new_tokens
        else:
            streams &= len(toks) == min(r.max_new_tokens,
                                        r.cancel_after or 10 ** 9)
    lo.update(constrained_streams=len(parsed), parsed=sum(parsed))
    lo_checks.update(
        streams=streams, schemas_parse=bool(parsed) and all(parsed),
        adapter_census=res.adapter_stats["invariant_ok"],
        grammar_census=res.grammar_stats["invariant_ok"],
        adapters_used=res.adapter_stats["uploads"] > 0,
        ragged_lane_ran=lo["ragged_prefill_calls"] > 0)
    del res, srv, adapters
    gc.collect()
    torch.cuda.empty_cache()

    # 2. speculative decoding
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    draft = LlamaForCausalLM(_llama32_1b_draft(), device=dev, seed=1)
    srv = llama_serving_decode_factory(model, draft=draft, **build)
    del model, draft
    gc.collect()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def spec_engine(clock, tracer, spec=True):
        return ServingEngine(
            serving=srv, slots=f["slots"], policy="paged", clock=clock,
            trace=tracer, spec=SpecConfig(n_draft=f["n_draft"],
                                          accept_floor=0.0) if spec else None)

    sp, sp_checks, res = _features_run("spec", spec_engine, spec_trace, L,
                                       n_pages)
    sp["setup_s"] = setup_s
    sp["draft"] = {"config": "llama3_2_1b widths", "layers": 16,
                   "cut": "plain rope (no llama3 rope scaling)"}
    st = res.spec_stats
    sp_checks.update(
        streams=all(len(res.outputs[r.rid]) == min(
            r.max_new_tokens, r.cancel_after or 10 ** 9)
            for r in spec_trace),
        spec_rounds=st["rounds"] > 0,
        acceptance_in_range=0.0 <= st["acceptance_rate"] <= 1.0)
    # the same trace plain, on the same factory, outside the counted runs
    plain = spec_engine("fixed", None, spec=False).run(spec_trace)
    agree = sum(res.outputs[r.rid] == plain.outputs[r.rid]
                for r in spec_trace)
    # where each stream first leaves the plain run's (its length where
    # it never does): one flip of a near-tie argmax, then another history
    split = [next((i for i, (a, b) in enumerate(zip(
        res.outputs[r.rid], plain.outputs[r.rid])) if a != b),
        len(res.outputs[r.rid])) for r in spec_trace]
    sp["streams_equal_plain"] = {"equal": agree, "of": len(spec_trace),
                                 "share": agree / len(spec_trace),
                                 "first_difference_at": split}
    del res, plain, srv
    gc.collect()
    torch.cuda.empty_cache()
    sp["f32_control"] = _spec_f32_control(dev, build, spec_trace)

    runs = (lo, sp)
    out.update({"engines": {r["engine"]: r for r in runs},
                "checks": {"lora_grammar_ragged": lo_checks,
                           "spec": sp_checks},
                "launches": sum(r["launches"] for r in runs),
                "launches_by_instance": {
                    k: sum(r["launches_by_instance"][k] for r in runs)
                    for k in lo["launches_by_instance"]},
                "decode_steps": sum(r["decode_steps"] for r in runs)})
    ok = all(all(c.values()) for c in (lo_checks, sp_checks))
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("serve_features phase failed: "
                             + json.dumps(out["checks"]))
    return out


# --- phase 7: the multi-replica serving layer, Llama-3-8B replicas --------

# serve_cluster: three factories of one seeded Llama-3-8B (16 layers, bf16)
# with serve_engine's geometry: A and B over bf16 pools of 64-token pages,
# C over int8 pools of 32-token pages holding the same 16,384 tokens. The
# fixed-clock parts start the trace at 0 and divide its arrivals by
# ENGINE_INTERARRIVAL, so one mean interarrival is one fixed-cost action
# (about one decode turn, as it is on the measured clock); the
# disaggregated parts price a handoff at kv_transfer_unit a page.
SERVE_CLUSTER = dict(SERVE_ENGINE, int8_page_size=32, kv_transfer_unit=0.05,
                     measured_requests=16, layers=16)
# the f32 case: ENGINE_SMALL's model and factories, the int8 decode
# replica over pages of 8
CLUSTER_SMALL_INT8_PAGE = 8


def _fixed_arrivals(trace):
    """``trace`` in the fixed clock's units (see SERVE_CLUSTER), its first
    arrival at 0 (where a fault plan's clock starts)."""
    t0 = min(r.arrival for r in trace)
    return [dataclasses.replace(
        r, arrival=(r.arrival - t0) / ENGINE_INTERARRIVAL) for r in trace]


def _want_lengths(trace):
    return {r.rid: min(r.max_new_tokens, r.cancel_after or 10 ** 9)
            for r in trace}


def _cluster_replay(dev, factories, names, clock, trace, L, slots,
                    events=(), **router_kw):
    """One ``ClusterRouter`` replay of two replicas (more may join),
    ``names`` mapping each replica name the router may spawn onto a
    factory of ``factories``, between a reset and a read of the paged
    kernel's counts. Returns (result, readings):
    the wall time, the decode steps by replica (from the trace's
    ``decode`` spans, whose tracks the router prefixes with the replica's
    name), the launches by instance and over int8 pages, and the peak
    memory."""
    from paddle_tpu_torch.obs import Tracer
    from paddle_tpu_torch.ops import paged_attention
    from paddle_tpu_torch.serving import ClusterRouter, ServingEngine

    def spawn(name):
        return ServingEngine(serving=factories[names[name]], slots=slots,
                             policy="paged", clock=clock)

    tracer = Tracer()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _zero_paged_counts()
    t0 = time.perf_counter()
    res = ClusterRouter(spawn, 2, trace=tracer, **router_kw).run(
        trace, events=events)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_instance = _paged_counts()
    tracks = {e["tid"]: e["args"]["name"]
              for e in tracer.to_chrome()["traceEvents"]
              if e["name"] == "thread_name"}
    steps = {}
    for s in _engine_spans(tracer.events, "decode"):
        rep = tracks[s["tid"]].split("/")[0]
        steps[rep] = steps.get(rep, 0) + s["args"].get("n", 1)
    transforms = {k: [1e3 * s["args"]["wall_s"] for s in
                      _engine_spans(tracer.events, k)]
                  for k in ("kv_repage", "kv_transcode")}
    return res, {"wall_s": wall, "decode_steps": steps,
                 "launches": launches, "launches_by_instance": by_instance,
                 "int8_launches": paged_attention.int8_launches,
                 "launches_expected": L * sum(steps.values()),
                 "transform_host_ms": transforms,
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30
                 if cuda else None}


def _cluster_readings(res, run, trace, L, int8_replicas=(), card=True):
    """The readings and checks of one cluster replay: census conserved
    (every request counted once), every stream at min(budget,
    cancel_after) tokens, and (on the card) paged launches == L x the
    decode steps summed over all replicas, all ``split``, the int8 ones
    those of ``int8_replicas``."""
    outs = res.outputs()
    got = {rid: len(o) for rid, o in outs.items()}
    cen = res.census()
    rep = res.report()
    generated = sum(got.values())
    placed = {}
    for led in res.ledger.values():
        placed[led["path"][0]] = placed.get(led["path"][0], 0) + 1
    steps = run["decode_steps"]
    checks = {"conserved": cen["conserved"] and not cen["lost"]
              and not cen["duplicated"],
              "streams_full": got == _want_lengths(trace)}
    if card:
        checks["launches"] = (
            sum(steps.values()) > 0
            and run["launches"] == run["launches_expected"]
            and run["launches_by_instance"] == {
                "split": run["launches_expected"], "mma": 0, "rows": 0}
            and run["int8_launches"] == L * sum(
                steps.get(n, 0) for n in int8_replicas))
    out = {**run, "requests": len(trace), "generated_tokens": generated,
           "tokens_per_s_wall": generated / run["wall_s"],
           "virtual": {k: rep[k] for k in (
               "makespan", "tokens_per_sec", "goodput_tokens_per_sec",
               "ttft_p50", "ttft_p95", "tpot_p50", "tpot_p95")},
           "placed_first_on": placed,
           "prefix_hit_tokens": {n: r["prefix_hit_tokens"]
                                 for n, r in rep["per_replica"].items()},
           "census": cen, "checks": checks}
    return out


def _streams_matching(a, b):
    """How many of ``a``'s streams equal ``b``'s, and the first position
    where any two differ (None where none does)."""
    same = sum(a[rid] == b.get(rid) for rid in a)
    first = [next((i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                   if x != y), None) for rid in a if rid in b]
    first = [i for i in first if i is not None]
    return {"equal": same, "of": len(a),
            "first_difference_at": min(first) if first else None}


def _cluster_small(dev, placements=("least_loaded", "disaggregated")):
    """The f32 case: ENGINE_SMALL's model on the card and on the CPU as a
    2-replica cluster on the fixed clock, under ``least_loaded`` (over two
    f32 factories) and ``disaggregated`` (an f32 prefill
    replica, an int8 decode replica over pages of 8), or the one of them
    that ``placements`` names. On the card the ``least_loaded`` cluster's
    outputs equal a lone engine's, and both clusters' outputs, slot logs
    and censuses equal the CPU's (the int8 transcode is lossy, so the
    disaggregated run is held card against CPU only). Returns (its
    readings, ok). The card test
    ``test_serving_cluster_on_the_card_matches_the_cpu`` runs it too."""
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_serving_decode_factory,
                                             load_numpy_state_dict)
    from paddle_tpu_torch.serving import ServingEngine

    e = ENGINE_SMALL
    cfg = LlamaConfig.tiny(vocab=e["vocab"], hidden=e["hidden"],
                           layers=e["layers"], heads=e["heads"],
                           kv_heads=e["kv_heads"])
    L = cfg.num_hidden_layers
    state = {k: v.numpy() for k, v in
             LlamaForCausalLM(cfg, device="cpu", seed=15).state_dict()
             .items()}
    trace = _engine_small_trace()
    setups = {"least_loaded": ({"r0": "a", "r1": "b"},
                               dict(placement="least_loaded"), ()),
              "disaggregated": ({"r0": "a", "r1": "c"},
                                dict(placement="disaggregated",
                                     roles={"r0": "prefill",
                                            "r1": "decode"},
                                     kv_transfer_unit=0.1), ("r1",))}
    runs, lone = {}, {}
    for d in (dev, torch.device("cpu")):
        model = load_numpy_state_dict(LlamaForCausalLM(cfg, device=d), state)

        def factory(ps, kv_quant=None):
            return llama_serving_decode_factory(
                model, max_len=e["max_len"], page_size=ps,
                n_pool_pages=e["slots"] * (e["max_len"] // ps) + 1,
                batch_capacity=e["slots"], chunked_prefill=ps,
                kv_quant=kv_quant, device=d)
        facs = {"a": factory(e["page_size"]), "b": factory(e["page_size"]),
                "c": factory(CLUSTER_SMALL_INT8_PAGE, "int8")}
        card = d.type != "cpu"
        for name in placements:
            names, kw, int8 = setups[name]
            res, run = _cluster_replay(d, facs, names, "fixed", trace, L,
                                       e["slots"], **kw)
            r = _cluster_readings(res, run, trace, L, int8, card=card)
            r["slot_logs"] = {n: x.slot_log for n, x in res.results.items()}
            r["outputs"] = res.outputs()
            runs[d.type, name] = r
        lone[d.type] = ServingEngine(serving=facs["a"], slots=e["slots"],
                                     policy="paged", clock="fixed").run(
                                         trace).outputs
    n = len(trace)
    card, cpu = dev.type, "cpu"
    checks = {
        "lone_engine_card_equals_cpu": lone[card] == lone[cpu],
        "card_equals_cpu": all(
            runs[card, k][f] == runs[cpu, k][f] for k in placements
            for f in ("outputs", "slot_logs", "census")),
        "cpu_launches_zero": all(runs[cpu, k]["launches"] == 0
                                 for k in placements),
    }
    if "least_loaded" in placements:
        checks["least_loaded_equals_lone_engine"] = (
            runs[card, "least_loaded"]["outputs"] == lone[card])
    if "disaggregated" in placements:
        ho = runs[card, "disaggregated"]["census"]["handoffs"]
        checks["handoffs"] = (
            ho["balanced"] and ho["imported"] == n and ho["failed"] == 0
            and ho.get("resharded") == {"page": n, "codec": n})
    for k in placements:
        for c, v in runs[card, k]["checks"].items():
            checks[f"{k}_{c}"] = v
        for c, v in runs[cpu, k]["checks"].items():
            checks[f"{k}_cpu_{c}"] = v
    ok = all(checks.values())
    keep = ("decode_steps", "launches", "int8_launches", "launches_expected",
            "census")
    return ({"config": {k: e[k] for k in ("hidden", "heads", "kv_heads",
                                          "layers", "page_size", "slots")},
             "int8_page_size": CLUSTER_SMALL_INT8_PAGE, "requests": n,
             "runs": {k: {f: runs[card, k][f] for f in keep}
                      for k in placements},
             "checks": checks, "ok": ok}, ok)


def _cluster_factories(dev):
    """A, B and C from one seeded Llama-3-8B, then the model is dropped
    (each factory holds its own stacked layers; the embedding and head
    are shared)."""
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_serving_decode_factory)

    e = SERVE_CLUSTER
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=e["layers"])
    model = LlamaForCausalLM(cfg, device=dev, seed=0)

    def factory(ps, kv_quant=None):
        return llama_serving_decode_factory(
            model, max_len=e["max_len"], page_size=ps,
            n_pool_pages=e["slots"] * (e["max_len"] // ps) + 1,
            batch_capacity=e["slots"], chunked_prefill=e["chunked_prefill"],
            kv_quant=kv_quant)
    facs = {"A": factory(e["page_size"]), "B": factory(e["page_size"]),
            "C": factory(e["int8_page_size"], "int8")}
    del model
    gc.collect()
    return cfg, facs


def _pool_gib(srv):
    from paddle_tpu_torch.models.nlp.llama_decode import tree_device_bytes

    return tree_device_bytes(srv.paged_parts[2]) / 2 ** 30


def _transform_ms(facs, e):
    """CUDA-event ms of the two handoff transforms on a 500-token chain
    of A's pool (8 pages of 64): ``repage_kv_data`` to 16 pages of 32 (the
    last 12 slots padded), then ``transcode_kv_data`` to int8 (median of
    REPS)."""
    from paddle_tpu_torch.models.nlp.llama_decode import (repage_kv_data,
                                                          transcode_kv_data)

    n_tok, ps, ps_to = 500, e["page_size"], e["int8_page_size"]
    pools = facs["A"].paged_parts[2]
    ids = torch.arange(1, -(-n_tok // ps) + 1, device=pools[0].device)
    chain = tuple(p[:, :, ids] for p in pools)
    paged = repage_kv_data(chain, ps, ps_to, n_tok)
    return {"tokens": n_tok,
            "repage_ms": gpu_ms(lambda: repage_kv_data(chain, ps, ps_to,
                                                       n_tok)),
            "transcode_ms": gpu_ms(lambda: transcode_kv_data(
                paged, None, "int8"))}


def phase_serve_cluster(dev):
    """The multi-replica serving layer: ``ClusterRouter`` over replicas of
    Llama-3-8B (16 layers, bf16, seeded) on factories A, B (bf16 pools,
    pages of 64) and C (int8 pools, pages of 32), each replica a
    ``ServingEngine(slots=8, policy="paged")``, on ``_serve_engine_trace``:
    placement (a fixed-clock replay of 12 requests through
    ``least_loaded`` twice, identical, and once through a lone engine on
    A; then ``least_loaded`` and ``prefix_aware`` on the measured clock
    over the first ``measured_requests``),
    drain and join (``r1`` drained and a replica on C joined mid-trace),
    disaggregated prefill/decode (the decode replica on B, a twin, then on
    C, where every handoff is re-paged and transcoded to int8) and chaos
    (``synthesize_fault_plan(seed=0)`` under ``FailoverConfig()``, beside
    the fault-free run). Each replay between a reset and a read of the
    paged kernel's counts; first the f32 case card against CPU
    (``_cluster_small``)."""
    from paddle_tpu_torch.serving import (FailoverConfig, ServingEngine,
                                          synthesize_fault_plan)

    e = SERVE_CLUSTER
    small, small_ok = _cluster_small(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, facs = _cluster_factories(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L, slots = cfg.num_hidden_layers, e["slots"]
    trace = _serve_engine_trace(cfg.vocab_size)
    fixed = _fixed_arrivals(trace)
    n = len(trace)
    out = {"phase": "serve_cluster", "model": "llama3_8b", "layers": L,
           "cut": CUT, "dtype": "bfloat16", "requests": n,
           "setup_s": setup_s,
           "memory": {"build_peak_gb": build_peak,
                      "after_build_gb": torch.cuda.memory_allocated()
                      / 2 ** 30,
                      "pool_gb": {k: _pool_gib(s) for k, s in facs.items()},
                      "build": "one model, three factories"},
           "small_f32": small}
    checks = {"small_f32": small_ok}
    parts = {}

    def replay(name, names, clock, tr, int8=(), events=(), **kw):
        res, run = _cluster_replay(dev, facs, names, clock, tr, L, slots,
                                   events=events, **kw)
        r = _cluster_readings(res, run, tr, L, int8)
        for c, v in r["checks"].items():
            checks[f"{name}_{c}"] = v
        parts[name] = r
        return res, r

    # 1. placement: a fixed-clock replay of the first requests, twice,
    # and through a lone engine on A; then the measured clock
    first = sorted(fixed, key=lambda r: (r.arrival, r.rid))[:e["replay"]]
    ab = {"r0": "A", "r1": "B"}
    reps = []
    for i in range(2):
        res, _ = replay(f"replay_{i}", ab, "fixed", first,
                        placement="least_loaded")
        reps.append((res.outputs(), {k: r.slot_log
                                     for k, r in res.results.items()},
                     res.census()))
    checks["replay_identical"] = reps[0] == reps[1]
    lone = ServingEngine(serving=facs["A"], slots=slots, policy="paged",
                         clock="fixed").run(first).outputs
    out["replay_vs_lone_engine"] = m = _streams_matching(reps[0][0], lone)
    # held in bf16 too: the replicas' batches changed no stream on an
    # H100 (PERF.md §6)
    checks["replay_equals_lone_engine"] = m["equal"] == m["of"]
    # the measured clock over the first half of the trace, which keeps
    # the whole script within its time limit (serve_engine measures the
    # whole trace through one engine)
    half = sorted(trace, key=lambda r: (r.arrival, r.rid))[
        :e["measured_requests"]]
    measured = {}
    for pl in ("least_loaded", "prefix_aware"):
        res, _ = replay(pl, ab, "measured", half, placement=pl)
        measured[pl] = res.outputs()
    out["least_loaded_vs_prefix_aware"] = _streams_matching(
        measured["least_loaded"], measured["prefix_aware"])
    del measured, reps, lone

    # 2. drain r1 and join r2 on C, mid-trace on the fixed clock
    t_mid = statistics.median(r.arrival for r in fixed)
    res, r = replay("drain_join", {"r0": "A", "r1": "B", "r2": "C"}, "fixed",
                    fixed, int8=("r2",), placement="least_loaded",
                    events=[(t_mid, "join", "r2"), (t_mid, "drain", "r1")])
    removed = [x for x in res.events if x["event"] == "remove"]
    r["drain_at"] = t_mid
    r["removed"] = removed
    checks["drain_join_removal"] = (
        [x["replica"] for x in removed] == ["r1"]
        and removed[0]["resident_pages"] == 0 and removed[0]["census_ok"]
        and r["census"]["removal_census_ok"])
    checks["drain_join_joined_served"] = len(res.results["r2"].outputs) > 0

    # 3. disaggregated: decode on B (a twin), then on C
    roles = {"r0": "prefill", "r1": "decode"}
    disagg = {}
    for name, dec, int8 in (("disagg_twin", "B", ()),
                            ("disagg_int8", "C", ("r1",))):
        res, r = replay(name, {"r0": "A", "r1": dec}, "fixed", fixed,
                        int8=int8, placement="disaggregated", roles=roles,
                        kv_transfer_unit=e["kv_transfer_unit"])
        ho = r["census"]["handoffs"]
        want = {"page": n, "codec": n} if dec == "C" else None
        checks[f"{name}_handoffs"] = (
            ho["balanced"] and ho["exported"] == ho["imported"] == n
            and ho["failed"] == 0 and ho.get("resharded") == want)
        disagg[dec] = res.outputs()
    out["disagg_int8_vs_twin"] = _streams_matching(disagg["C"], disagg["B"])
    out["transforms"] = _transform_ms(facs, e)
    del disagg

    # 4. chaos on A + B, beside the fault-free run of the same clock
    res, _ = replay("fault_free", ab, "fixed", fixed,
                    placement="least_loaded")
    free = res.outputs()
    span = max(r.arrival for r in fixed) - min(r.arrival for r in fixed)
    plan = synthesize_fault_plan(seed=0, replicas=["r0", "r1"], span=span)
    res, r = replay("chaos", ab, "fixed", fixed, placement="least_loaded",
                    faults=plan, failover=FailoverConfig(), slo=[])
    r["plan"] = [ev.to_json() for ev in plan]
    r["retried"] = r["census"].get("retried")
    r["failed"] = r["census"].get("failed")
    r["resumed_prefix_tokens"] = sum(len(v) for v in res.salvaged.values())
    r["incidents"] = len(res.incidents)
    r["vs_fault_free"] = _streams_matching(res.outputs(), free)
    checks["chaos_no_failed"] = r["failed"] == 0
    checks["chaos_failed_over"] = r["retried"] > 0
    checks["chaos_crashed"] = any(x["event"] == "crash" for x in res.events)
    del res, free

    out["parts"] = parts
    out["launches"] = sum(p["launches"] for p in parts.values())
    out["int8_launches"] = sum(p["int8_launches"] for p in parts.values())
    out["launches_by_instance"] = {
        k: sum(p["launches_by_instance"][k] for p in parts.values())
        for k in ("split", "mma", "rows")}
    out["decode_steps"] = sum(sum(p["decode_steps"].values())
                              for p in parts.values())
    out["peak_mem_gb"] = max([build_peak] + [p["peak_mem_gb"]
                                             for p in parts.values()])
    out["checks"] = checks
    ok = all(checks.values())
    out["ok"] = ok
    del facs
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    if not ok:
        raise AssertionError("serve_cluster phase failed: "
                             + json.dumps(checks))
    return out


# --- phase 7b: the memory tiers and dispatch-ahead, Llama-3-8B -----------

# serve_tiers: serve_engine's geometry and trace over one seeded Llama-3-8B
# (32 layers, bf16), two factories of it: one with a pressure pool, one
# plain. Pressure: a byte budget of 60 % of the full-precision pool
# (compaction at allocation) and a QoS scheduler whose SLO monitor trips
# the tier at 50 % (a ThresholdRule on the pool's stored bytes). Host
# memory: 8 two-turn sessions (first prompts 256-512, turns of 64-128,
# 32-64 new tokens, 40 virtual s of thinking) and 2 high-priority
# requests, 8 slots, a pool of 41 pages (2,560 tokens) and a 1 GiB arena,
# on the fixed clock, so that its spills, page-ins and preemption are the
# ones rehearsed on SimServing (the same bookkeeping: 47 spills, 15
# page-ins, 1 preemption and 1 restore); the same trace on an ample pool
# (serve_engine's 257 pages) is the stream control. Dispatch-ahead:
# serve_engine's trace, paged, flag off then on, on the measured clock.
SERVE_TIERS = dict(SERVE_ENGINE, budget_frac=0.6, slo_frac=0.5,
                   hm_pages=41, hm_sessions=8, hm_high=2, arena_gib=1.0)


def _hostmem_trace(vocab):
    """8 two-turn sessions (each turn's prompt extends the history of the
    one before) and 2 priority-9 requests of another tenant arriving at
    5 and 15 virtual s, while the sessions' first turns run."""
    from paddle_tpu_torch.serving import (Request, merge_traces,
                                          synthesize_session_trace)

    t = SERVE_TIERS
    sessions = synthesize_session_trace(
        seed=0, n_sessions=t["hm_sessions"], turns=2, think_time=40.0,
        first_prompt_len=(256, 512), turn_prompt_len=(64, 128),
        output_len=(32, 64), vocab_size=vocab, mean_interarrival=2.0)
    high = [Request(rid=f"hi{i}",
                    prompt=tuple(range(1000 + 300 * i, 1256 + 300 * i)),
                    max_new_tokens=32, arrival=5.0 + 10.0 * i, priority=9,
                    tenant="t1") for i in range(t["hm_high"])]
    return merge_traces(sessions, high)


class _Watch:
    """Instrumentation of one serving run, undone on exit: the largest
    stored-byte census after any ``PagedKVCache.allocate``, every tensor
    the host arena takes (pinned or not, on the card or not), and the
    dispatch-ahead batches queued (with their decode steps)."""

    def __enter__(self):
        from paddle_tpu_torch.models.nlp.llama_decode import _leaves
        from paddle_tpu_torch.ops.paged_attention import PagedKVCache
        from paddle_tpu_torch.serving.engine import ServingEngine
        from paddle_tpu_torch.serving.hostmem import HostArena

        self.stored_peak, self.arena = 0, {"tensors": 0, "pinned": 0,
                                           "on_card": 0}
        self.ahead = {"dispatched": 0, "steps": 0}
        self._undo = []
        me = self

        def patch(cls, name, make):
            orig = getattr(cls, name)
            setattr(cls, name, make(orig))
            self._undo.append((cls, name, orig))

        def allocate(orig):
            def f(book, *a, **k):
                out = orig(book, *a, **k)
                sb = book.stored_bytes()
                if sb is not None:
                    me.stored_peak = max(me.stored_peak, int(sb))
                return out
            return f

        def put(orig):
            def f(arena, key, data, nbytes, **k):
                ts = [a for a in _leaves(data) if isinstance(a, torch.Tensor)]
                me.arena["tensors"] += len(ts)
                me.arena["pinned"] += sum(a.is_pinned() for a in ts)
                me.arena["on_card"] += sum(a.is_cuda for a in ts)
                return orig(arena, key, data, nbytes, **k)
            return f

        def ahead(orig):
            def f(eng, ahst, book, active, acache, n):
                orig(eng, ahst, book, active, acache, n)
                if ahst.emits is not None:
                    me.ahead["dispatched"] += 1
                    me.ahead["steps"] += n
            return f

        patch(PagedKVCache, "allocate", allocate)
        patch(HostArena, "put", put)
        patch(ServingEngine, "_dispatch_ahead_turn", ahead)
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._undo):
            setattr(cls, name, orig)


def _tier_run(name, make, trace, L, n_pages, clock="measured"):
    """One engine of serve_tiers on ``trace`` between a reset and a read
    of the paged kernel's counts, under ``_Watch``. ``make(clock,
    tracer)`` builds the engine. Returns (readings, checks, result)."""
    from paddle_tpu_torch.obs import Tracer

    tracer = Tracer()
    eng = make(clock, tracer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_paged_counts()
    with _Watch() as w:
        t0 = time.perf_counter()
        res = eng.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, by_instance = _paged_counts()
    events = tracer.events
    decode = _engine_spans(events, "decode")
    steps = sum(s["args"].get("n", 1) for s in decode)
    served = [s for s in decode if s["args"].get("ahead")]
    discarded = w.ahead["dispatched"] - len(served)
    # a discarded dispatch launched its steps and left no span
    steps_run = steps + (w.ahead["steps"] - sum(
        s["args"].get("n", 1) for s in served))
    rep = res.report()
    got = {rid: len(out) for rid, out in res.outputs.items()}
    want = {r.rid: min(r.max_new_tokens, r.cancel_after or 10 ** 9)
            for r in trace}
    generated = sum(got.values())
    cs = res.cache_stats
    out = {"engine": name, "clock": clock, "requests": len(trace),
           "completed": rep["completed"], "cancelled": rep["evicted"],
           "shed": len(res.shed), "generated_tokens": generated,
           "wall_s": wall, "tokens_per_s_wall": generated / wall,
           "ttft_p50_s": rep["ttft_p50"], "ttft_p95_s": rep["ttft_p95"],
           "tpot_p50_s": rep["tpot_p50"],
           "decode_turns": len(decode), "decode_steps": steps,
           "decode_turn_ms_median": _median_ms(decode),
           "prefill_ms_median": _median_ms(_engine_spans(events, "prefill")),
           "kv_pageout_ms_median": _median_ms(
               _engine_spans(events, "kv_pageout")),
           "kv_pagein_ms_median": _median_ms(
               _engine_spans(events, "kv_pagein")),
           "ahead": {"dispatched": w.ahead["dispatched"],
                     "served": len(served), "discarded": discarded,
                     "served_turn_ms_median": _median_ms(served),
                     "fresh_turn_ms_median": _median_ms(
                         [s for s in decode if not s["args"].get("ahead")])},
           "kv_quant_stats": res.kv_quant_stats,
           "hostmem_stats": res.hostmem_stats, "cache_stats": cs,
           "stored_bytes_peak": w.stored_peak, "arena_tensors": w.arena,
           "overhead": res.overhead, "launches": launches,
           "launches_by_instance": by_instance,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    checks = {
        "streams": got == want,
        "page_census": (cs["resident_pages"] + cs["evictable_pages"]
                        + cs["free_pages"] == cs["n_pages"] == n_pages - 1
                        and cs["invariant_ok"]),
        "launches_split_only": by_instance == {"split": L * steps_run,
                                               "mma": 0, "rows": 0}
        and launches == L * steps_run}
    return out, checks, res


def _streams_equal(a, b):
    """How many of ``a``'s streams equal ``b``'s, of how many."""
    return {"equal": sum(a.outputs[r] == b.outputs.get(r) for r in a.outputs),
            "of": len(a.outputs)}


def _page_transfer_ms(eng):
    """CUDA-event ms of one page's spill (the export and its pinned host
    copy) and page-in (the copy back into the pool) at this engine's
    pool, median of 25: the transfer a ``kv_pageout`` / ``kv_pagein``
    span charges."""
    from paddle_tpu_torch.models.nlp.llama_decode import _leaves
    from paddle_tpu_torch.serving.engine import _to_host

    data = _to_host(eng.export_kv_pages([1]))
    out = {"bytes": sum(int(a.nbytes) for a in _leaves(data)),
           "pageout_ms": gpu_ms(lambda: _to_host(eng.export_kv_pages([1]))),
           "pagein_ms": gpu_ms(lambda: eng.import_kv_pages([1], data))}
    out["pcie_gbps"] = out["bytes"] / (out["pagein_ms"] * 1e6)
    return out


def phase_serve_tiers(dev):
    """Llama-3-8B, full width and depth, bf16, seeded weights: the pressure
    page tier, the host-memory tier and dispatch-ahead turns through
    ``ServingEngine(policy="paged")`` (SERVE_TIERS). Each run sits between
    a reset and a read of the paged kernel's counts: every launch must be
    a decode step's (``split``, 32 a step; a dispatched-ahead batch that
    was discarded launched its steps too); the streams min(budget,
    cancel_after) tokens; the page census conserved."""
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_serving_decode_factory)
    from paddle_tpu_torch.obs import ThresholdRule
    from paddle_tpu_torch.serving import (HostMemConfig, QoSScheduler,
                                          ServingEngine)

    t = SERVE_TIERS
    cfg = LlamaConfig.llama3_8b()
    L = cfg.num_hidden_layers
    ps, C, slots = t["page_size"], t["chunked_prefill"], t["slots"]
    n_pages = slots * (t["max_len"] // ps) + 1
    build = dict(max_len=t["max_len"], page_size=ps, batch_capacity=slots,
                 chunked_prefill=C)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    plain = llama_serving_decode_factory(model, n_pool_pages=n_pages,
                                         **build)
    tiered = llama_serving_decode_factory(model, n_pool_pages=n_pages,
                                          kv_quant="pressure", **build)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trace = _serve_engine_trace(cfg.vocab_size)
    out = {"phase": "serve_tiers", "model": "llama3_8b", "layers": L,
           "dtype": "bfloat16", "setup_s": setup_s,
           "build_peak_mem_gb": build_peak}
    checks, parts = {}, {}

    # dispatch-ahead: a fixed-clock replay of the first 12 requests with
    # the flag off and on, then the measured runs; the flag-off run is
    # also the untiered control of the pressure part
    def plain_engine(ahead):
        def make(clock, tracer):
            return ServingEngine(serving=plain, slots=slots, policy="paged",
                                 clock=clock, trace=tracer,
                                 dispatch_ahead=ahead)
        return make

    first = sorted(trace, key=lambda r: (r.arrival, r.rid))[:t["replay"]]
    fixed = [plain_engine(a)("fixed", None).run(first) for a in (False,
                                                                 True)]
    checks["ahead_fixed_identical"] = (
        fixed[0].outputs == fixed[1].outputs
        and fixed[0].slot_log == fixed[1].slot_log
        and fixed[0].report() == fixed[1].report()
        and len(fixed[0].outputs) == len(first))
    del fixed
    runs = {}
    for ahead in (False, True):
        name = "ahead_on" if ahead else "ahead_off"
        parts[name], c, runs[name] = _tier_run(
            name, plain_engine(ahead), trace, L, n_pages)
        checks.update({f"{name}_{k}": v for k, v in c.items()})
    checks["ahead_served"] = parts["ahead_on"]["ahead"]["served"] > 0
    parts["ahead_on"]["streams_equal_ahead_off"] = _streams_equal(
        runs["ahead_on"], runs["ahead_off"])

    # pressure: the budget and the SLO-tripped tier on the measured clock
    fp_page = tiered.page_bytes_[0]
    budget = int(fp_page * (n_pages - 1) * t["budget_frac"])

    def pressure(clock, tracer):
        return ServingEngine(
            serving=tiered, slots=slots, policy="paged", clock=clock,
            trace=tracer, scheduler=QoSScheduler(), kv_quant_budget=budget,
            slo=[ThresholdRule(name="pool_pressure",
                               signal="pool_bytes_per_device",
                               bound=float(fp_page * (n_pages - 1)
                                           * t["slo_frac"]),
                               op=">=", severity="page")])

    parts["pressure"], c, res = _tier_run("pressure", pressure, trace, L,
                                          n_pages)
    qs = res.kv_quant_stats
    parts["pressure"].update({
        "budget_bytes": budget, "fp_page_bytes": fp_page,
        "q_page_bytes": tiered.page_bytes_[1],
        "incidents": len(res.incidents or []),
        "streams_equal_untiered": _streams_equal(res, runs["ahead_off"])})
    checks.update({f"pressure_{k}": v for k, v in c.items()})
    checks["pressure_compacted"] = (qs["compactions"] > 0
                                    and qs["quantized_pages"] > 0)
    checks["pressure_within_budget"] = (
        0 < parts["pressure"]["stored_bytes_peak"] <= budget)
    del res, runs
    gc.collect()

    # host memory on the fixed clock: a factory with the small pool and
    # the arena, then the plain factory's ample pool as the control
    del tiered
    gc.collect()
    small = llama_serving_decode_factory(model, n_pool_pages=t["hm_pages"],
                                         **build)
    del model
    gc.collect()
    hm_trace = _hostmem_trace(cfg.vocab_size)
    arena = int(t["arena_gib"] * 2 ** 30)

    def hostmem(srv, arena_bytes):
        def make(clock, tracer):
            return ServingEngine(
                serving=srv, slots=slots, policy="paged", clock=clock,
                trace=tracer, scheduler=QoSScheduler(),
                hostmem=(HostMemConfig(byte_budget=arena_bytes)
                         if arena_bytes else None))
        return make

    parts["hostmem"], c, res = _tier_run(
        "hostmem", hostmem(small, arena), hm_trace, L, t["hm_pages"],
        clock="fixed")
    hs = res.hostmem_stats
    checks.update({f"hostmem_{k}": v for k, v in c.items()})
    checks["hostmem_moved"] = (hs["spills"] > 0 and hs["pageins"] > 0
                               and hs["preempts"] > 0
                               and hs["restores"] > 0)
    checks["hostmem_arena"] = (
        hs["arena_census_ok"] is True
        and hs["arena"]["peak_bytes"] <= arena
        and parts["hostmem"]["arena_tensors"]["tensors"] > 0
        and parts["hostmem"]["arena_tensors"]["pinned"]
        == parts["hostmem"]["arena_tensors"]["tensors"]
        and parts["hostmem"]["arena_tensors"]["on_card"] == 0)
    parts["hostmem"]["page_transfer"] = _page_transfer_ms(
        ServingEngine(serving=small, slots=slots, policy="paged"))
    ample_out, _, ample = _tier_run("hostmem_ample", hostmem(plain, None),
                                    hm_trace, L, n_pages, clock="fixed")
    parts["hostmem"]["streams_equal_ample_pool"] = _streams_equal(res,
                                                                  ample)
    parts["hostmem_ample"] = ample_out
    del res, ample, small, plain
    gc.collect()
    torch.cuda.empty_cache()
    _release_pinned()        # the arena's pinned pages back to the host
    out["parts"] = parts
    out["launches"] = sum(p["launches"] for p in parts.values())
    out["launches_by_instance"] = {
        k: sum(p["launches_by_instance"][k] for p in parts.values())
        for k in ("split", "mma", "rows")}
    out["decode_steps"] = sum(p["decode_steps"] for p in parts.values())
    out["checks"] = checks
    ok = all(checks.values())
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("serve_tiers phase failed: "
                             + json.dumps(checks))
    return out


# --- phase 7c: the dense decode options at full width --------------------

# decode_options: int8 weights on Llama-3-8B (B=8, a 512-token prompt, 64
# tokens) against the bf16 factory; the rolling cache on Mistral-7B's
# widths (window 4096, 32 layers, B=1, a 4608-token prompt so that the
# rolled prefill runs, 64 tokens) against the model's own windowed forward
# (the splash kernels); the speculative factory with a Llama-3-8B target
# and a draft at Llama-3.2-1B's widths (seeded, untrained; n_draft 4, a
# 512-token prompt, 128 tokens) against plain greedy decode.
DECODE_OPTIONS = dict(B=8, prompt=512, new=64, roll_prompt=4608, roll_new=64,
                      spec_prompt=512, spec_new=128, n_draft=4)
# the teacher-forced logits' relative error (Frobenius, over the 64 steps
# and 8 rows) of int8 weights against bf16, each a limit about twice its
# first reading: weights alone 0.393, with the int8 KV cache 0.399 (one
# H100 80GB HBM3 at 700 W; PERF.md §2). Per-tensor activation scales over
# random weights at 32 layers: the method's error, the card's product
# being the CPU's exact int32 one
INT8_LOGIT_REL = {"w8": 0.8, "w8_kv8": 0.8}
# the rolling cache's decode logits against the windowed forward (splash),
# relative error over the 64 positions: a bf16 limit about twice the
# first reading, 0.0925 (PERF.md §2)
ROLLING_LOGIT_REL = 0.19


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _teacher(gen, tokens, S0):
    """The factory's logits for each of ``tokens``' positions S0-1 ..
    S-2 fed the given tokens (teacher forcing): its prefill on the first
    S0, then one decode step a token. Returns (logits (S - S0, B, V) f32
    on the factory's device, ms a decode step: host clock over the steps,
    up to the card's finish)."""
    p = gen._parts
    B, S = tokens.shape
    if p["rolling"]:
        lg, kc, vc = p["prefill"](p["outer"], p["layers"], tokens[:, :S0])
    else:
        dt = p["outer"]["model.embed_tokens.weight"].dtype
        lg, kc, vc = p["prefill"](p["outer"], p["layers"], tokens[:, :S0],
                                  p["init_caches"](B, dt),
                                  p["init_caches"](B, dt))
    out = [lg.float()]
    _sync()
    t0 = time.perf_counter()
    for pos in range(S0, S - 1):
        lg, kc, vc = p["decode_step"](p["outer"], p["layers"],
                                      tokens[:, pos], pos, kc, vc)
        out.append(lg.float())
    _sync()
    ms = 1e3 * (time.perf_counter() - t0) / max(1, S - 1 - S0)
    return torch.stack(out), ms


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _agree(a, b):
    """The share of rows and positions whose argmax agrees."""
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def _decode_int8(dev):
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_decode_factory)
    from paddle_tpu_torch.models.nlp.llama_decode import _PROJ_KEYS, _leaves

    d = DECODE_OPTIONS
    cfg = LlamaConfig.llama3_8b()
    S0, new = d["prompt"], d["new"]
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (d["B"], S0)), device=dev)

    def proj_bytes(gen):
        lay, head = gen._parts["layers"], gen._parts["outer"].get(
            "lm_head.weight")
        return sum(int(a.nbytes) for k in _PROJ_KEYS
                   for a in _leaves(lay[k])) + sum(
            int(a.nbytes) for a in _leaves(head))

    out = {"B": d["B"], "prompt": S0, "new": new}
    gen = llama_decode_factory(model, max_len=S0 + new)
    tokens = torch.as_tensor(gen.compiled(prompts, new), device=dev)
    ref, ms = _teacher(gen, tokens, S0)
    out["bf16"] = {"ms_per_token": ms, "proj_bytes": proj_bytes(gen)}
    del gen
    gc.collect()
    for name, kv in (("w8", None), ("w8_kv8", "int8")):
        torch.cuda.reset_peak_memory_stats()
        gen = llama_decode_factory(model, max_len=S0 + new,
                                   weight_dtype="int8", kv_cache_dtype=kv)
        lg, ms = _teacher(gen, tokens, S0)
        dtypes = sorted({str(a.dtype) for k in _PROJ_KEYS
                         for a in _leaves(gen._parts["layers"][k])})
        out[name] = {"ms_per_token": ms, "proj_bytes": proj_bytes(gen),
                     "proj_dtypes": dtypes,
                     "bytes_ratio": proj_bytes(gen)
                     / out["bf16"]["proj_bytes"],
                     "logit_rel_err": _rel(lg, ref),
                     "logit_rel_limit": INT8_LOGIT_REL[name],
                     "argmax_agree": _agree(lg, ref),
                     "peak_mem_gb": torch.cuda.max_memory_allocated()
                     / 2 ** 30}
        del gen, lg
        gc.collect()
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()
    checks = {f"{n}_{k}": v for n in ("w8", "w8_kv8") for k, v in (
        ("int8", out[n]["proj_dtypes"] == ["torch.float32", "torch.int8"]),
        ("half_bytes", out[n]["bytes_ratio"] <= 0.52),
        ("logits", out[n]["logit_rel_err"] <= INT8_LOGIT_REL[n]))}
    return out, checks


def _decode_rolling(dev):
    from paddle_tpu_torch.models.nlp import LlamaForCausalLM, \
        llama_decode_factory

    d = DECODE_OPTIONS
    cfg = _mistral_7b()
    S0, new = d["roll_prompt"], d["roll_new"]
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    gen = llama_decode_factory(model, max_len=S0 + new)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (1, S0)), device=dev)
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.as_tensor(gen.compiled(prompt, new), device=dev)
    lg, ms = _teacher(gen, tokens, S0)
    slots = gen._parts["init_caches"](1, cfg.dtype).shape[3]
    del gen
    gc.collect()
    # the model's own forward over the same tokens, padded to a length
    # the splash kernels take (a multiple of 128; causal, so the pad
    # changes no earlier logit)
    pad = -(tokens.shape[1]) % 128
    full = torch.cat([tokens, tokens[:, :pad]], 1)
    counts = ("launches_fwd", "launches_dq", "launches_dkv")
    owner = _counters()[0]["splash"]
    for c in counts:
        setattr(owner, c, 0)
    with torch.no_grad():
        fwd = model(full)[0, S0 - 1:S0 - 1 + new].float()[:, None]
    launched = {c: getattr(owner, c) for c in counts}
    out = {"prompt": S0, "new": new, "window": cfg.sliding_window,
           "cache_slots": slots, "forward_len": full.shape[1],
           "ms_per_token": ms, "logit_rel_err": _rel(lg, fwd),
           "logit_max_abs_err": float((lg - fwd).abs().max()),
           "logit_rel_limit": ROLLING_LOGIT_REL,
           "argmax_agree": _agree(lg, fwd), "splash_launches": launched,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    del model, fwd, lg
    gc.collect()
    torch.cuda.empty_cache()
    L = cfg.num_hidden_layers
    checks = {"rolling_slots": slots == cfg.sliding_window,
              "rolling_logits": out["logit_rel_err"] <= ROLLING_LOGIT_REL,
              "rolling_splash": launched == {"launches_fwd": L,
                                             "launches_dq": 0,
                                             "launches_dkv": 0}}
    return out, checks


def _decode_spec(dev):
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_decode_factory,
                                             llama_speculative_decode_factory)

    d = DECODE_OPTIONS
    S0, new, k = d["spec_prompt"], d["spec_new"], d["n_draft"]
    max_len = S0 + new + 2 * (k + 1)
    cfg = LlamaConfig.llama3_8b()
    prompt = np.random.default_rng(2).integers(1, cfg.vocab_size, (1, S0))
    out = {"prompt": S0, "new": new, "n_draft": k}

    # f32 at 2 layers, the target as its own draft: exactly plain greedy
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    small = LlamaForCausalLM(dataclasses.replace(
        cfg, num_hidden_layers=2, dtype=torch.float32), device=dev, seed=0)
    spec = llama_speculative_decode_factory(small, small, max_len=max_len,
                                            n_draft=k)
    got = spec.compiled(prompt, new)
    want = llama_decode_factory(small, max_len=max_len).compiled(prompt, new)
    out["f32_self_draft"] = {"layers": 2, "equal": bool((got == want).all()),
                             "stats": spec.compiled.last_stats}
    del small, spec
    gc.collect()
    torch.backends.cuda.matmul.allow_tf32 = tf32

    target = LlamaForCausalLM(cfg, device=dev, seed=0)
    draft = LlamaForCausalLM(_llama32_1b_draft(), device=dev, seed=1)
    spec = llama_speculative_decode_factory(target, draft, max_len=max_len,
                                            n_draft=k)
    plain = llama_decode_factory(target, max_len=max_len)
    del target, draft
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    for name, fn in (("plain", plain.compiled), ("spec", spec.compiled)):
        fn(prompt, 8)                                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(prompt, new)
        torch.cuda.synchronize()
        times[name] = (1e3 * (time.perf_counter() - t0) / new, res)
    (ms_p, want), (ms_s, got) = times["plain"], times["spec"]
    gen = got[0, S0:] == want[0, S0:]
    out["bf16"] = {"ms_per_token": ms_s, "plain_ms_per_token": ms_p,
                   "stats": spec.compiled.last_stats,
                   "equal_share": float(gen.mean()),
                   "first_difference_at": int(np.argmin(gen)) if not
                   gen.all() else new,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    del spec, plain
    gc.collect()
    torch.cuda.empty_cache()
    st = out["f32_self_draft"]["stats"]
    checks = {"spec_f32_self_draft_equal": out["f32_self_draft"]["equal"],
              "spec_f32_self_draft_steps": st["target_steps"]
              < -(-new // 3),
              "spec_stats": out["bf16"]["stats"]["tokens"] == new}
    return out, checks


def phase_decode_options(dev):
    """The dense decode options at full width (DECODE_OPTIONS): int8
    weights, the rolling cache, the speculative factory. None launches a
    paged kernel; the rolling part's windowed forward launches splash's
    forward once a layer."""
    _zero_paged_counts()
    out = {"phase": "decode_options", "dtype": "bfloat16"}
    checks = {}
    for name, part in (("int8_weights", _decode_int8),
                       ("rolling", _decode_rolling),
                       ("speculative", _decode_spec)):
        t0 = time.perf_counter()
        out[name], c = part(dev)
        out[name]["wall_s"] = time.perf_counter() - t0
        checks.update(c)
    launches, _ = _paged_counts()
    checks["no_paged_launch"] = launches == 0
    out["splash_launches"] = out["rolling"]["splash_launches"]
    out["checks"] = checks
    ok = all(checks.values())
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("decode_options phase failed: "
                             + json.dumps(checks))
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


# --- phase 8: train Llama-3-8B, Llama-2-7B and Mistral-7B (8 layers) -------

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


# --- phases 9-10: Llama-3-8B at full depth with its moments in pinned host
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


# --- phase 11: train Qwen2-57B-A14B's widths (the MoE model) ---------------

# train_moe: MoEConfig.qwen2_57b_a14b() at full width, bf16, seeded, the
# deepest cut of its 28 layers that fits the card (the example's
# ``fitting_depth``), B=1 x S=4096, dispatch "indexed", the chunked CE in
# chunks of 16384 (the reference's advice for V = 151,936), no remat,
# AdamW lr 1e-4; one warm-up step, then 5 timed
MOE_CELL = dict(B=1, S=4096, lr=1e-4, chunked=16384, steps=5, warmup=1)
# 2-layer bf16 forward+backward at full width, grouped flash kernels vs
# their plain versions, identical weights and batch: bf16 roundings in 2
# layers (|Δloss| reading 6.3e-5 of 12.71 on one H100; limit about twice
# it). The router reads bf16 logits, so an attention rounding flips
# near-tie expert choices: 2.9 % of layer 0's (token, choice) pairs and
# 5.4 % of layer 1's differ between the two runs. A flip moves a token's
# share of the gradient from one expert (and router column) to another,
# so the routed parameters' error follows the flips, not bf16's rounding:
# reading 0.093 (layer 1's w_in), limit about twice it. Every other
# parameter (attention, shared expert, norms, embedding) reads at most
# 0.018 (median 0.011), limit about twice that.
MOE_LOSS_ATOL = 1.5e-4
MOE_GRAD_REL = {"routed": 0.2, "other": 0.04}
ROUTED = ("gate.wg", ".mlp.w_")


def _qwen2_57b():
    from paddle_tpu_torch.models.nlp import MoEConfig

    return MoEConfig.qwen2_57b_a14b()


def _routing_hooks(model, record):
    """Forward hooks on every MoE layer: each call appends the layer's
    (expert ids, keep) of its (token, choice) pairs, recomputed from its
    input by the layer's own router and ``topk_gating_idx``."""
    from paddle_tpu_torch.incubate.distributed.models.moe import \
        topk_gating_idx

    def hook(module, inputs, output):
        x = inputs[0]
        T = x.shape[0] * x.shape[1]
        with torch.no_grad():
            glt = module.gate.wg(x).reshape(T, -1).to(torch.float32)
            eids, _, keep, _, _ = topk_gating_idx(glt, module.capacity(T),
                                                  module.top_k)
        record.append((eids, keep))

    return [layer.mlp.register_forward_hook(hook) for layer in model.layers
            if layer.use_moe]


def _moe_batch(vocab, B, S, seed, dev):
    """The batch the example's ``train`` makes from ``seed``."""
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, vocab, (B, S + 1)))
    return tok[:, :-1].to(dev), tok[:, 1:].to(dev)


def _moe_grads_with(swap, model, params, tokens, labels, chunked):
    """Loss, gradients and each MoE layer's routing of one forward and
    backward of ``moe_loss``; ``swap`` runs the plain attention versions
    in place of the kernels."""
    from paddle_tpu_torch.models.nlp.moe import moe_loss

    record = []
    hooks = _routing_hooks(model, record)
    try:
        with _plain_versions("gqa", swap):
            loss = moe_loss(model, tokens, labels, chunked)
            grads = torch.autograd.grad(loss, list(params.values()))
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return float(loss.detach()), grads, record


def _grad_groups(rel):
    """The largest relative gradient error of each kind of parameter."""
    kinds = (("router", "gate.wg"), ("experts", ".mlp.w_"),
             ("shared", "shared_mlp"), ("attention", "self_attn"),
             ("norms", "norm"), ("embedding", "embed_tokens"))
    return {kind: max((v for k, v in rel.items() if key in k), default=None)
            for kind, key in kinds}


def _moe_checks(dev, full, B, S, chunked):
    """At full width and ``CHECK_LAYERS`` layers: one forward+backward
    with the grouped flash kernels and one with their plain versions on
    identical weights and batch: |Δloss|, every parameter's relative
    gradient error, and the share of expert choices that differ between
    the two runs (near-ties in the bf16 router flipped by an attention
    rounding)."""
    from paddle_tpu_torch.models.nlp import MoEForCausalLM

    cfg = dataclasses.replace(full, num_hidden_layers=CHECK_LAYERS)
    model = MoEForCausalLM(cfg, device=dev, seed=0).to(torch.bfloat16)
    params = {k: p.requires_grad_() for k, p in model.named_parameters()}
    tokens, labels = _moe_batch(cfg.vocab_size, B, S, 0, dev)
    loss_k, grads_k, route_k = _moe_grads_with(False, model, params, tokens,
                                               labels, chunked)
    loss_p, grads_p, route_p = _moe_grads_with(True, model, params, tokens,
                                               labels, chunked)
    rel = _rel_errs(params, grads_k, grads_p)
    # each expert's own relative error in each routed weight, over the
    # experts the plain run routed tokens to; an expert it left empty
    # (capacity drops, a collapsed router) has a zero gradient there
    by_expert = {}
    for k, a, b in zip(params, grads_k, grads_p):
        if ".mlp.w_" in k:
            diff = (a.float() - b.float()).flatten(1).norm(dim=1)
            norm = b.float().flatten(1).norm(dim=1)
            live = norm > 0
            e = diff[live] / norm[live]
            by_expert[k] = {"median": float(e.median()),
                            "max": float(e.max()),
                            "empty_experts": int((~live).sum())}
    del grads_k, grads_p
    worst = max(rel, key=rel.get)
    routed = {k: v for k, v in rel.items() if any(r in k for r in ROUTED)}
    other = {k: v for k, v in rel.items() if k not in routed}
    flips = [float((ek != ep).float().mean())
             for (ek, _), (ep, _) in zip(route_k, route_p)]
    dropped = [1 - float(keep.float().mean()) for _, keep in route_k]
    out = {"layers": CHECK_LAYERS, "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_diff": abs(loss_k - loss_p),
           "loss_atol": MOE_LOSS_ATOL, "grad_rel_err_max": rel[worst],
           "grad_rel_err_worst": worst,
           "grad_rel_err_median": statistics.median(rel.values()),
           "grad_rel_err_by_kind": _grad_groups(rel),
           "grad_rel_err_by_expert": by_expert,
           "grad_rel_err_routed_max": max(routed.values()),
           "grad_rel_err_other_max": max(other.values()),
           "grad_rel_limit": MOE_GRAD_REL,
           "choice_flip_share_by_layer": flips,
           "dropped_share_by_layer": dropped}
    out["ok"] = (out["loss_diff"] <= MOE_LOSS_ATOL
                 and max(routed.values()) <= MOE_GRAD_REL["routed"]
                 and max(other.values()) <= MOE_GRAD_REL["other"])
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _moe_time_parts(res, chunked):
    """Two more steps on the trained model, host clock, each up to a
    synchronise: a forward and backward alone (the gradients dropped),
    then one whole step of the factory's ``train_step``. Returns
    (fwd_bwd_ms, update_ms), the update being the step less the forward
    and backward."""
    from paddle_tpu_torch.models.nlp.moe import moe_loss

    params = res["params"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = moe_loss(res["model"], res["tokens"], res["labels"], chunked)
    grads = torch.autograd.grad(loss, list(params.values()))
    del loss, grads
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res["params"], res["opt_state"], _ = res["step"](
        params, res["opt_state"], res["tokens"], res["labels"])
    torch.cuda.synchronize()
    fwd_bwd, step = t1 - t0, time.perf_counter() - t1
    return 1e3 * fwd_bwd, 1e3 * (step - fwd_bwd)


def _moe_routing(res, chunked):
    """One more forward (no gradient) at the trained weights: the weighted
    aux loss and each MoE layer's share of (token, choice) pairs dropped
    for capacity."""
    from paddle_tpu_torch.models.nlp.moe import moe_loss

    model, record = res["model"], []
    hooks = _routing_hooks(model, record)
    try:
        with torch.no_grad():
            loss = float(moe_loss(model, res["tokens"], res["labels"],
                                  chunked))
            aux = float(model.aux_loss())
    finally:
        for h in hooks:
            h.remove()
    return {"loss": loss, "aux_loss": aux,
            "dropped_share_by_layer": [1 - float(keep.float().mean())
                                       for _, keep in record]}


def phase_train_moe(dev, profile=False):
    from paddle_tpu_torch.examples.train_moe import (fitting_depth,
                                                     param_count, train)

    c = MOE_CELL
    B, S, chunked = c["B"], c["S"], c["chunked"]
    full = _qwen2_57b()
    checks = _moe_checks(dev, full, B, S, chunked)

    # the depth: the deepest cut whose weights, gradients and moments, the
    # step's peak above them and the allocator's fragments fit the card
    free, card_bytes = torch.cuda.mem_get_info(dev)
    layers = fitting_depth(full, free)
    n_params = param_count(full, layers)
    cut = None if layers == full.num_hidden_layers else (
        f"{layers} of {full.num_hidden_layers} layers, full width: the "
        f"deepest that fitting_depth takes for {free / 2 ** 30:.2f} GiB "
        f"free ({n_params / 1e9:.3f} B parameters x 12 bytes of bf16 "
        f"weights and gradients and f32 AdamW moments, plus the step's "
        f"peak above them and the allocator's fragments); {layers + 1} "
        f"layers hold {12 * param_count(full, layers + 1) / 2 ** 30:.2f} "
        f"GiB of state")
    cfg = dataclasses.replace(full, num_hidden_layers=layers)

    # the main path: launch counts from 0, a warm-up step and 5 timed ones
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    t0 = time.perf_counter()
    res = train(cfg, B, S, c["steps"], lr=c["lr"], device=dev, seed=0,
                dtype=torch.bfloat16, chunked_vocab_ce=chunked,
                warmup=c["warmup"], log=None)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _train_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved_gib = torch.cuda.max_memory_reserved() / 2 ** 30
    steps = c["steps"] + c["warmup"]
    want = {k: 0 for k in counts}
    want.update({"gqa_fwd": layers * steps, "gqa_dq": layers * steps,
                 "gqa_dkv": layers * steps})
    model, opt = res["model"], res["opt_state"]
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    moment_bytes = sum(t.numel() * t.element_size() for n in ("m", "v")
                       for t in opt[n].values())
    fwd_bwd_ms, update_ms = _moe_time_parts(res, chunked)
    routing = _moe_routing(res, chunked)
    losses = res["losses"]
    step_s = statistics.median(res["step_s"])
    activated = model.activated_params()
    hd = cfg.hidden_size // cfg.num_attention_heads
    pairs = B * cfg.num_attention_heads * _live_pairs_per_head(S, None)
    flops = 6 * activated * B * S + 12 * hd * pairs * layers
    cap = model.layers[0].mlp.capacity(B * S)
    out = {"phase": "train_moe", "model": "qwen2_57b_a14b", "layers": layers,
           "layers_full": full.num_hidden_layers, "cut": cut,
           "params": n_params, "activated_params": activated,
           "hidden": cfg.hidden_size, "heads": cfg.num_attention_heads,
           "kv_heads": cfg.num_key_value_heads, "vocab": cfg.vocab_size,
           "experts": cfg.num_experts, "top_k": cfg.top_k,
           "shared_expert_intermediate": cfg.shared_intermediate(),
           "capacity_per_expert": cap,
           "dispatch_mode": cfg.dispatch_mode, "dtype": "bfloat16",
           "B": B, "S": S, "steps": c["steps"], "warmup_steps": c["warmup"],
           "lr": c["lr"], "remat": False, "chunked_vocab_ce": chunked,
           "losses": losses, "warmup_losses": res["warmup_losses"],
           "step_ms_median": 1e3 * step_s,
           "step_ms": [1e3 * t for t in res["step_s"]],
           "fwd_bwd_ms": fwd_bwd_ms, "update_ms": update_ms,
           "main_path_s": run_s, "tokens_per_s": B * S / step_s,
           "peak_mem_gib": peak_gib, "peak_reserved_gib": reserved_gib,
           "free_before_gib": free / 2 ** 30,
           "card_gib": card_bytes / 2 ** 30, "param_bytes": param_bytes,
           "moment_bytes": moment_bytes, "step_flops": flops,
           "mfu": flops / step_s / BF16_FLOP_PER_S,
           "mfu_formula": "(6*activated_params*tokens + 12*head_dim*pairs*"
                          "layers) / step_s / 989e12; the routed experts "
                          "compute at capacity (E*C = "
                          f"{cfg.num_experts}*{cap} slots for "
                          f"{B * S}*{cfg.top_k} pairs, "
                          f"{cfg.capacity_factor} x their top_k/E share): "
                          "the extra is not counted",
           "routing_after_training": routing,
           "launches": counts, "launches_expected": want,
           "launches_per_step": {"gqa_fwd": layers, "gqa_dq": layers,
                                 "gqa_dkv": layers, "ce": 0},
           "checks": checks}
    ok = (counts == want and checks["ok"] and all(np.isfinite(losses))
          and losses[-1] < losses[0])
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("train_moe phase failed: " + json.dumps(out))
    if profile:
        emit({"phase": "profile_train_moe", **_profile(
            lambda: float(res["step"](res["params"], res["opt_state"],
                                      res["tokens"], res["labels"])[2]),
            {"flash_attention": ("causalwalk",), "matmul": MATMUL_NAMES,
             "index_scatter_gather": ("index", "scatter", "gather"),
             "elementwise": ("elementwise",), "reduce": ("reduce",)},
            n=3)})
    del res, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- phase 12: train the fused encoder (incubate.nn) at BERT-base width ---

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


# --- phase 13: BERT-base pretraining (models/nlp/bert.py) ------------------

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


# --- phase 13b: the eager training API on BERT-base (optimizer, amp) -------

def _eager_loss(model, batch):
    """The everyday loop's loss: the model, then its ``loss``
    (``F.cross_entropy`` of the MLM and NSP heads)."""
    ids, types, mlm, nsp = batch
    return model.loss(*model(ids, types), mlm, nsp)


def _eager_opt(model):
    """The phase's optimizer and scheduler: AdamW over a linear warm-up
    into a polynomial decay, weight decay 0.01, the global-norm clip."""
    from paddle_tpu_torch import nn as pnn, optimizer

    sched = optimizer.lr.LinearWarmup(
        optimizer.lr.PolynomialDecay(EAGER["lr"], 1000, 0.0), 2, 0.0,
        EAGER["lr"])
    opt = optimizer.AdamW(learning_rate=sched,
                          parameters=model.parameters(),
                          weight_decay=0.01,
                          grad_clip=pnn.ClipGradByGlobalNorm(1.0))
    return opt, sched


def _eager_step(model, opt, sched, scaler, batch, level):
    """One step of the everyday loop under ``auto_cast(level)``; returns
    the loss read on the host."""
    from paddle_tpu_torch import amp

    with amp.auto_cast(level=level, dtype="bfloat16"):
        loss = _eager_loss(model, batch)
    scaled = scaler.scale(loss)
    scaled.backward()
    scaler.minimize(opt, scaled)      # calls update() itself
    opt.clear_grad()
    sched.step()
    return float(loss.detach())


def _eager_fwd_bwd(model, batch, level):
    """The forward and backward alone (the gradients dropped), up to a
    synchronise: host seconds."""
    from paddle_tpu_torch import amp

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with amp.auto_cast(level=level, dtype="bfloat16"):
        loss = _eager_loss(model, batch)
    torch.autograd.grad(loss, [p for p in model.parameters()
                               if p.requires_grad])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _census_summary(census):
    """{op name: {"in -> out": calls}} of a dispatch census."""
    out = {}
    for name, calls in census.items():
        kinds = out.setdefault(name, {})
        for ins, outs in calls:
            key = f"{','.join(ins)} -> {','.join(outs)}"
            kinds[key] = kinds.get(key, 0) + 1
    return out


def _eager_checks(dev, cfg, batch):
    """Kernels against plain versions under O1: one forward and backward
    of a 2-layer BERT at full width (f32 parameters), identical weights,
    batch and dropout draws. Returns (loss diff, {param: rel grad err},
    {noise param: rel grad err})."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.models.nlp import BertForPretraining

    seed = EAGER["seed"]
    gen = Generator(seed)
    small = BertForPretraining(dataclasses.replace(
        cfg, num_hidden_layers=EAGER["check_layers"]), device=dev,
        generator=gen)
    small.train()
    names = [k for k, _ in small.named_parameters()]

    def run(swap):
        with _swapped(_mha_swaps(), swap):
            gen.manual_seed(seed + 2)
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = _eager_loss(small, batch)
            grads = torch.autograd.grad(loss, list(small.parameters()))
            torch.cuda.synchronize()
        return float(loss.detach()), grads

    loss_k, grads_k = run(False)
    loss_p, grads_p = run(True)
    rel, noise = {}, {}
    for k, a, b in zip(names, grads_k, grads_p):
        (noise if k.endswith(NOISE_GRAD_PARAMS) else rel)[k] = float(
            (a.float() - b.float()).norm() / b.float().norm())
    del small, grads_k, grads_p
    return loss_k, loss_p, rel, noise


def _eager_part(model, batch, level, init, flash_dtypes):
    """One part of train_eager: the model reset to ``init``, a fresh
    optimizer, scheduler and GradScaler (``decorate`` at O2), a warm-up
    step (with the op census), then launch counts from 0 and the timed
    steps, then a forward and backward alone and one more whole step (the
    optimizer's share)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import dispatch

    e = EAGER
    model.float()
    model.load_state_dict(init)
    opt, sched = _eager_opt(model)
    if level == "O2":
        model, opt = amp.decorate(model, opt, level="O2")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    flash_dtypes.clear()
    with dispatch.census() as census:
        warmup = [_eager_step(model, opt, sched, scaler, batch, level)
                  for _ in range(e["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    losses, step_s, masters_ok = [], [], True
    for _ in range(e["steps"]):
        t0 = time.perf_counter()
        losses.append(_eager_step(model, opt, sched, scaler, batch, level))
        step_s.append(time.perf_counter() - t0)
        if level == "O2":
            masters_ok = masters_ok and all(
                torch.equal(p, opt._accumulators[id(p)]["_master"]
                            .to(p.dtype)) for p in model.parameters())
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd_bwd = _eager_fwd_bwd(model, batch, level)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _eager_step(model, opt, sched, scaler, batch, level)
    whole = time.perf_counter() - t0
    summary = _census_summary(census)
    param_dtypes = sorted({str(p.dtype).removeprefix("torch.")
                           for p in model.parameters()})
    ins = {name: sorted({i for i, _ in census.get(name, [])})
           for name in ("layer_norm", "cross_entropy")}
    outs = {name: sorted({o for _, o in census.get(name, [])})
            for name in ("layer_norm", "cross_entropy")}
    out = {"level": level, "warmup_losses": warmup, "losses": losses,
           "step_ms": [1e3 * t for t in step_s],
           "step_ms_median": 1e3 * statistics.median(step_s),
           "fwd_bwd_ms": 1e3 * fwd_bwd, "whole_step_ms": 1e3 * whole,
           "optimizer_ms": 1e3 * (whole - fwd_bwd),
           "optimizer_share": (whole - fwd_bwd) / whole,
           "peak_mem_gb": peak_gb, "launches": counts,
           "param_dtypes": param_dtypes,
           "flash_input_dtypes": sorted(flash_dtypes),
           "census": summary, "loss_scale": scaler._scale,
           "lr_last": opt.get_lr()}
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
          and flash_dtypes == {("bfloat16",) * 3})
    if level == "O1":
        ok = (ok and param_dtypes == ["float32"]
              and ins["cross_entropy"] == [("float32", "int64")]
              and all(o == ("float32",) for o in outs["layer_norm"]))
    else:
        out["masters_equal_params"] = masters_ok
        ok = ok and masters_ok and "bfloat16" in param_dtypes
    out["ok"] = ok
    del opt, sched, scaler
    return out


def phase_train_eager(dev):
    """BERT-base trained by the everyday Paddle loop (``loss.backward();
    opt.step(); opt.clear_grad()`` under ``amp.auto_cast``) through the
    port's ``optimizer``, ``optimizer.lr``, ``nn.ClipGradByGlobalNorm``
    and ``amp``: O1 then O2 (``amp.decorate``), each from the same initial
    weights."""
    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.models.nlp import BertConfig, BertForPretraining

    fm = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    e = EAGER
    B, S, seed = e["B"], e["S"], e["seed"]
    cfg = BertConfig()
    L, d, heads = (cfg.num_hidden_layers, cfg.hidden_size,
                   cfg.num_attention_heads)
    batch = _bert_batch(cfg.vocab_size, B, S, seed + 1, dev)
    loss_k, loss_p, rel, noise = _eager_checks(dev, cfg, batch)
    worst = max(rel, key=rel.get)
    gen = Generator(seed)               # weights, then every dropout draw
    model = BertForPretraining(cfg, device=dev, generator=gen)
    model.train()
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    flash_dtypes = set()
    real_fwd = fm.mha_fwd

    def spy(q, k, v, *a, **kw):
        flash_dtypes.add(tuple(str(t.dtype).removeprefix("torch.")
                               for t in (q, k, v)))
        return real_fwd(q, k, v, *a, **kw)

    parts = {}
    with _swapped([(fm, "mha_fwd", spy)]):
        for level in ("O1", "O2"):
            parts[level] = _eager_part(model, batch, level, init,
                                       flash_dtypes)
    want = {k: 0 for k in parts["O1"]["launches"]}
    want.update({"mha_fwd": L * e["steps"], "mha_dq": L * e["steps"],
                 "mha_dkv": L * e["steps"]})
    F_, V = cfg.intermediate_size, cfg.vocab_size
    matmul_params = L * (4 * d * d + 2 * d * F_) + d * d + d * V
    pairs = B * heads * S * S                    # non-causal
    flops = 6 * matmul_params * B * S + 12 * (d // heads) * pairs * L
    for part in parts.values():
        step = part["step_ms_median"] / 1e3
        part.update({"tokens_per_s": B * S / step,
                     "mfu": flops / step / BF16_FLOP_PER_S,
                     "launches_expected": want,
                     "ok": part["ok"] and part["launches"] == want})
    total = {}
    for part in parts.values():
        for k, n in part["launches"].items():
            total[k] = total.get(k, 0) + n
    out = {"phase": "train_eager", "model": "bert_base",
           "config": dataclasses.asdict(cfg), "layers": L,
           "param_dtype": "float32 (O1); bfloat16 + float32 masters (O2)",
           "B": B, "S": S, "tokens_per_step": B * S,
           "steps": e["steps"], "warmup_steps": e["warmup"],
           "optimizer": "AdamW(LinearWarmup(PolynomialDecay(1e-4, 1000, "
                        "0.0), 2, 0.0, 1e-4), weight_decay=0.01, "
                        "grad_clip=ClipGradByGlobalNorm(1.0)); "
                        "GradScaler(init_loss_scaling=2**15)",
           "step_flops": flops, "matmul_params": matmul_params,
           "mfu_formula": "as train_bert: (6*matmul_params*tokens + "
                          "12*head_dim*pairs*layers) / step_s / 989e12",
           "O1": parts["O1"], "O2": parts["O2"], "launches": total,
           "check_layers": e["check_layers"],
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_diff": abs(loss_k - loss_p),
           "loss_atol": EAGER_LOSS_ATOL,
           "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
           "grad_rel_err_median": statistics.median(rel.values()),
           "grad_rel_limit": EAGER_GRAD_REL, "grad_rel_err": rel,
           "noise_grad_rel_err": noise}
    ok = (parts["O1"]["ok"] and parts["O2"]["ok"]
          and out["loss_diff"] <= EAGER_LOSS_ATOL
          and rel[worst] <= EAGER_GRAD_REL)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("train_eager phase failed: " + json.dumps(
            {k: v for k, v in out.items()
             if k not in ("grad_rel_err", "config")}))
    del model, init
    torch.cuda.empty_cache()
    return out


# --- phase 14: ResNet-50 training (vision/models/resnet.py) ----------------

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


# --- phase 15: GPT-2 small pretraining (models/nlp/gpt.py) ----------------

def phase_train_gpt(dev):
    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.models.nlp import (GPTConfig, GPTForCausalLM,
                                             gpt_pretrain_step_factory)
    from paddle_tpu_torch.models.nlp.gpt import lm_loss

    g = GPT
    B, S, steps, seed = g["B"], g["S"], g["steps"], g["seed"]
    cfg = GPTConfig()
    L, d, heads = (cfg.num_hidden_layers, cfg.hidden_size,
                   cfg.num_attention_heads)
    model = GPTForCausalLM(cfg, device=dev, generator=Generator(seed)) \
        .to(torch.bfloat16)
    model.train()
    tg = torch.Generator(device=dev).manual_seed(seed + 1)
    ids = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=tg,
                        device=dev)
    tokens, labels = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    params, opt, step = gpt_pretrain_step_factory(model, device=dev)

    # the main path: a warm-up step, then launch counts from 0 and the
    # timed steps, each up to its loss on the host
    warmup = [float(step(params, opt, tokens, labels)[2])
              for _ in range(g["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(params, opt, tokens, labels)[2]))
        step_s.append(time.perf_counter() - t0)
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # a forward and backward alone, in eval() as inside the step
    model.eval()
    t0 = time.perf_counter()
    torch.autograd.grad(lm_loss(model, tokens, labels),
                        list(params.values()))
    torch.cuda.synchronize()
    fwd_bwd_s = time.perf_counter() - t0
    # greedy generation by recomputation at B = 1
    _zero_train_counts()
    prompt = tokens[:1, :g["prompt"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generated = model.generate(prompt, max_new_tokens=g["new_tokens"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = _train_counts()
    model.train()

    want = {k: 0 for k in counts}
    step_med = statistics.median(step_s)
    F, V = cfg.intermediate_size, cfg.vocab_size
    matmul_params = L * (4 * d * d + 2 * d * F) + d * V
    pairs = B * heads * S * (S + 1) // 2                    # causal
    flops = 6 * matmul_params * B * S + 12 * (d // heads) * pairs * L
    out = {"phase": "train_gpt", "model": "gpt2_small",
           "config": dataclasses.asdict(cfg), "layers": L,
           "dtype": "bfloat16", "B": B, "S": S, "tokens_per_step": B * S,
           "steps": steps, "warmup_steps": g["warmup"],
           "warmup_losses": warmup,
           "optimizer": "AdamW lr 1e-4, weight decay 0.01, betas (0.9, "
                        "0.95), eps 1e-8, f32 moments",
           "losses": losses, "step_ms_median": 1e3 * step_med,
           "step_ms": [1e3 * t for t in step_s],
           "fwd_bwd_ms": 1e3 * fwd_bwd_s, "tokens_per_s": B * S / step_med,
           "peak_mem_gb": peak_gb, "step_flops": flops,
           "matmul_params": matmul_params,
           "mfu": flops / step_med / BF16_FLOP_PER_S,
           "mfu_formula": "(6*matmul_params*tokens + 12*head_dim*pairs*"
                          "layers) / step_s / 989e12; matmul_params = "
                          "L*(4d^2 + 2dF) + dV (the tied head once); pairs "
                          "= B*heads*S*(S+1)/2 (causal live pairs)",
           "launches": counts, "launches_expected": want,
           "generate": {"B": 1, "prompt": g["prompt"],
                        "new_tokens": g["new_tokens"],
                        "ms_per_token": 1e3 * gen_s / g["new_tokens"],
                        "launches": gen_counts,
                        "shape": list(generated.shape)}}
    ok = (counts == want and gen_counts == want and all(np.isfinite(losses))
          and losses[-1] < losses[0]
          and tuple(generated.shape) == (1, g["prompt"] + g["new_tokens"])
          and torch.equal(generated[:, :g["prompt"]], prompt)
          and int(generated.max()) < V and int(generated.min()) >= 0)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise AssertionError("train_gpt phase failed: " + json.dumps(out))
    del model, params, opt, step
    torch.cuda.empty_cache()
    return out


# --- phase 16: Transformer-base training and cached decode (nn) -------------

def _seq2seq_loss(model, src, tgt, mask, target):
    out = model(src, tgt, tgt_mask=mask)
    return torch.square(out.float() - target.float()).mean()


def _seq2seq_grads(swap, model, batch, gen, seed):
    """Loss and gradients of one forward and backward, the generator
    reseeded first so both calls draw the same dropout; ``swap`` runs the
    multi-head flash kernels' plain versions."""
    with _swapped(_mha_swaps(), swap):
        gen.manual_seed(seed)
        loss = _seq2seq_loss(model, *batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
    return float(loss.detach()), grads


def phase_transformer(dev):
    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.models.nlp import make_adamw_state
    from paddle_tpu_torch.models.nlp.train_utils import apply_adamw
    from paddle_tpu_torch.nn import MultiHeadAttention, Transformer

    c = SEQ2SEQ
    B, Ss, St, steps, lr, seed = (c["B"], c["S_src"], c["S_tgt"], c["steps"],
                                  c["lr"], c["seed"])
    gen = Generator(seed)               # weights, then every dropout draw
    model = Transformer(device=dev, generator=gen).to(torch.bfloat16)
    model.train()
    d, heads = model.d_model, model.nhead
    Le, Ld = len(model.encoder.layers), len(model.decoder.layers)
    F = model.encoder.layers[0].linear1.out_features
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    src, tgt, target = (torch.randn((B, S, d), generator=g, device=dev)
                        .to(torch.bfloat16) for S in (Ss, St, St))
    mask = Transformer.generate_square_subsequent_mask(St, device=dev)
    batch = (src, tgt, mask, target)

    # kernels against plain versions: one forward+backward each, identical
    # weights, batch and dropout draws
    loss_k, grads_k = _seq2seq_grads(False, model, batch, gen, seed + 2)
    loss_p, grads_p = _seq2seq_grads(True, model, batch, gen, seed + 2)
    rel, noise = {}, {}
    for (k, _), a, b in zip(model.named_parameters(), grads_k, grads_p):
        (noise if k.endswith(NOISE_GRAD_PARAMS) else rel)[k] = float(
            (a.float() - b.float()).norm() / b.float().norm())
    del grads_k, grads_p
    worst = max(rel, key=rel.get)

    # the main path: launch counts from 0, the training steps
    params = dict(model.named_parameters())
    opt = make_adamw_state(params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = _seq2seq_loss(model, *batch)
        grads = list(torch.autograd.grad(loss, list(params.values())))
        apply_adamw(params, grads, opt, lr, 0.9, 0.98, 1e-9, 0.01)
        losses.append(float(loss.detach()))
        step_s.append(time.perf_counter() - t0)
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: 0 for k in counts}
    want.update({"mha_fwd": (Le + Ld) * steps, "mha_dq": (Le + Ld) * steps,
                 "mha_dkv": (Le + Ld) * steps})
    del opt, grads

    # the cached decode: gen_cache(memory), then one-token steps
    model.eval()
    Bd, n = c["decode_B"], c["decode_steps"]
    with torch.no_grad():
        memory = model.encoder(src[:Bd])
        cache = [(MultiHeadAttention.Cache(*(t.to(torch.bfloat16)
                                             for t in incr)), static)
                 for incr, static in model.decoder.gen_cache(memory)]
        x = tgt[:Bd, :1]
        torch.cuda.synchronize()
        _zero_train_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            x, cache = model.decoder(x, memory, cache=cache)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    decode_counts = _train_counts()
    model.train()

    step_med = statistics.median(step_s)
    hd = d // heads
    enc_params = Le * (4 * d * d + 2 * d * F)
    dec_params = Ld * (8 * d * d + 2 * d * F)
    enc_pairs = B * heads * Ss * Ss                 # non-causal
    cross_pairs = B * heads * St * Ss               # non-causal
    self_pairs = B * heads * St * (St + 1) // 2     # causal live pairs
    flops = 6 * (enc_params * B * Ss + dec_params * B * St) \
        + 12 * hd * (enc_pairs * Le + (cross_pairs + self_pairs) * Ld)
    out = {"phase": "transformer", "model": "transformer_base",
           "config": {"d_model": d, "nhead": heads, "num_encoder_layers": Le,
                      "num_decoder_layers": Ld, "dim_feedforward": F,
                      "dropout": 0.1, "activation": "relu",
                      "normalize_before": False},
           "dtype": "bfloat16", "B": B, "S_src": Ss, "S_tgt": St,
           "steps": steps, "lr": lr,
           "optimizer": "AdamW lr 1e-4, betas (0.9, 0.98), eps 1e-9, "
                        "weight decay 0.01, f32 moments",
           "loss": "MSE against N(0, 1), causal tgt_mask",
           "losses": losses, "step_ms_median": 1e3 * step_med,
           "step_ms": [1e3 * t for t in step_s],
           "tokens_per_s": B * (Ss + St) / step_med,
           "peak_mem_gb": peak_gb, "step_flops": flops,
           "mfu": flops / step_med / BF16_FLOP_PER_S,
           "mfu_formula": "(6*(enc_params*B*S_src + dec_params*B*S_tgt) + "
                          "12*head_dim*(enc_pairs*Le + (cross_pairs + "
                          "causal_self_pairs)*Ld)) / step_s / 989e12; "
                          "enc_params = Le*(4d^2 + 2dF), dec_params = "
                          "Ld*(8d^2 + 2dF)",
           "launches": counts, "launches_expected": want,
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_diff": abs(loss_k - loss_p),
           "loss_atol": SEQ2SEQ_LOSS_ATOL,
           "grad_rel_err_max": rel[worst], "grad_rel_err_worst": worst,
           "grad_rel_err_median": statistics.median(rel.values()),
           "grad_rel_limit": SEQ2SEQ_GRAD_REL,
           "noise_grad_rel_err_max": max(noise.values()),
           "decode": {"B": Bd, "memory": Ss, "steps": n,
                      "cache_dtype": str(cache[0][0].k.dtype),
                      "out_dtype": str(x.dtype),
                      "ms_per_step": 1e3 * decode_s / n,
                      "launches": decode_counts,
                      "cache_len": int(cache[0][0].k.shape[1])}}
    ok = (counts == want and decode_counts == {k: 0 for k in counts}
          and all(np.isfinite(losses)) and losses[-1] < losses[0]
          and out["loss_diff"] <= SEQ2SEQ_LOSS_ATOL
          and rel[worst] <= SEQ2SEQ_GRAD_REL
          and bool(torch.isfinite(x).all()) and x.dtype == torch.bfloat16
          and out["decode"]["cache_len"] == n)
    out["ok"] = ok
    emit({**out, "grad_rel_err": rel})
    if not ok:
        raise AssertionError("transformer phase failed: " + json.dumps(out))
    del model, params, cache, memory
    torch.cuda.empty_cache()
    return out


# --- phase 17: FusedMultiTransformer decode at GPT-2 small's widths ---------

def phase_fused_decode(dev):
    from paddle_tpu_torch.core import Generator
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.models.nlp import GPTConfig

    f = FUSED_DECODE
    B, max_len, n, seed = f["B"], f["max_len"], f["steps"], f["seed"]
    cfg = GPTConfig()
    model = FusedMultiTransformer(
        cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
        activation="gelu", normalize_before=True,
        num_layers=cfg.num_hidden_layers, device=dev,
        generator=Generator(seed)).to(torch.bfloat16).eval()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    xs = torch.randn((n, B, 1, cfg.hidden_size), generator=g,
                     device=dev).to(torch.bfloat16)
    with torch.no_grad():
        cache = model.gen_cache(B, max_len).to(torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_train_counts()
        t0 = time.perf_counter()
        for t in range(n):
            out, cache = model(xs[t], caches=cache, time_step=t)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    counts = _train_counts()
    res = {"phase": "fused_decode", "model": "gpt2_small_width_fused",
           "layer": "FusedMultiTransformer(768, 12, 3072, activation="
                    "'gelu', normalize_before=True, num_layers=12)",
           "dtype": "bfloat16", "B": B, "max_len": max_len, "steps": n,
           "cache_shape": list(cache.shape), "cache_dtype": str(cache.dtype),
           "ms_per_token": 1e3 * decode_s / n,
           "tokens_per_s": B * n / decode_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": counts, "launches_expected": {k: 0 for k in counts}}
    ok = (counts == res["launches_expected"]
          and bool(torch.isfinite(out).all())
          and out.dtype == torch.bfloat16
          and bool(cache[:, :, :, :, n - 1].abs().sum() > 0)
          and not cache[:, :, :, :, n:].any())
    res["ok"] = ok
    emit(res)
    if not ok:
        raise AssertionError("fused_decode phase failed: " + json.dumps(res))
    del model, cache, xs
    torch.cuda.empty_cache()
    return res


# --- phase 18: Zaremba's large PTB LSTM language model (nn/layer/rnn.py,
# the op namespace) ------------------------------------------------------------

# Zaremba, Sutskever & Vinyals, "Recurrent Neural Network Regularization"
# (2014), the "large" PTB model: vocab 10k, 2 x 1500 LSTM, unrolled 35,
# batch 20, dropout 0.65 on the non-recurrent connections, U(-0.04, 0.04),
# SGD lr 1 with the global norm clipped at 10, f32. The data is a seeded
# synthetic stream (a Zipf unigram over the vocabulary): PTB is not in the
# repository.
RNNLM = dict(vocab=10000, hidden=1500, layers=2, T=35, B=20, dropout=0.65,
             init=0.04, lr=1.0, clip=10.0, steps=5, warmup=1, seed=35,
             beam_B=8, beam=4, max_step_num=31, start=0, end=9999)
# card against CPU for the op sweep: TOLS of tests/torch_op_cases.py
# (1e-6 + 1e-6 rel; 1e-6 + 1e-5 rel for transcendental functions and for
# sums whose order differs), gradients 1e-5 + 1e-5 rel; the RNNs 1e-5
RNN_REF_ATOL = 1e-5


def _rnnlm_model(paddle, cfg):
    """The LM as a Paddle user writes it: embedding, dropout, a 2-layer
    ``nn.LSTM`` (dropout between its layers), dropout, an untied
    ``Linear``; every weight U(-init, init) by ``set_value``."""
    nn = paddle.nn

    class RnnLM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(cfg["vocab"], cfg["hidden"])
            self.lstm = nn.LSTM(cfg["hidden"], cfg["hidden"],
                                cfg["layers"], dropout=cfg["dropout"])
            self.drop = nn.Dropout(cfg["dropout"])
            self.fc = nn.Linear(cfg["hidden"], cfg["vocab"])

        def forward(self, ids, states):
            x = self.drop(self.embedding(ids))
            y, states = self.lstm(x, states)
            return self.fc(self.drop(y)), states

    model = RnnLM()
    for p in model.parameters():
        p.set_value(paddle.uniform(p.shape, min=-cfg["init"],
                                   max=cfg["init"]))
    return model


def _rnnlm_stream(cfg, n, seed):
    """``n`` token ids of a seeded Zipf(1.1) unigram stream."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, cfg["vocab"] + 1) ** 1.1
    return rng.choice(cfg["vocab"], n, p=w / w.sum()).astype(np.int64)


def _rnnlm_zero_states(paddle, cfg, B):
    z = paddle.zeros([cfg["layers"], B, cfg["hidden"]])
    return (z, paddle.zeros([cfg["layers"], B, cfg["hidden"]]))


def _beam_cell(paddle, cells):
    """A user's ``RNNCellBase`` running the LM's two ``LSTMCell``s."""
    class TwoLayers(paddle.nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.cells = torch.nn.ModuleList(cells)
            self.hidden_size = cells[0].hidden_size

        def forward(self, x, states):
            new = []
            for cell, st in zip(self.cells, states):
                x, st = cell(x, st)
                new.append(st)
            return x, new
    return TwoLayers()


def _lstm_yardstick(model, cfg, dev):
    """``torch.nn.LSTM`` (cuDNN) at the same widths with the port's
    weights copied in (the gates' order is the same): the time of one
    forward + backward of the stack, and its largest difference from the
    port's output on the same input. Recorded only; never on the path."""
    ref = torch.nn.LSTM(cfg["hidden"], cfg["hidden"], cfg["layers"],
                        batch_first=True).to(dev)
    with torch.no_grad():
        for k, cell in enumerate(model.lstm.cells):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(ref, f"{name}_l{k}").copy_(getattr(cell, name))
    g = torch.Generator(device=dev).manual_seed(cfg["seed"] + 7)
    x = torch.randn(cfg["B"], cfg["T"], cfg["hidden"], generator=g,
                    device=dev, requires_grad=True)
    cot = torch.randn(cfg["B"], cfg["T"], cfg["hidden"], generator=g,
                      device=dev)
    model.lstm.eval()
    # full f32 on both sides, as the port's products run
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False

    def port_fb():
        y = model.lstm(x)[0]
        (y * cot).sum().backward()
        torch.cuda.synchronize()
        return y

    def cudnn_fb():
        y = ref(x)[0]
        (y * cot).sum().backward()
        torch.cuda.synchronize()
        return y

    out = {}
    for name, fn in (("port", port_fb), ("cudnn", cudnn_fb)):
        fn()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            y = fn()
            ts.append(time.perf_counter() - t0)
        out[name] = (statistics.median(ts) * 1e3, y.detach())
    model.lstm.train()
    torch.backends.cudnn.allow_tf32 = tf32
    return {"lstm_fwd_bwd_ms": out["port"][0],
            "cudnn_lstm_fwd_bwd_ms": out["cudnn"][0],
            "cudnn_max_abs_diff": float((out["port"][1]
                                         - out["cudnn"][1]).abs().max())}


def phase_train_rnnlm(dev, profile=False):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import dispatch

    cfg = RNNLM
    B, T, V = cfg["B"], cfg["T"], cfg["vocab"]
    prev = paddle.resolve_device(None)      # put back after the phase
    paddle.set_device("gpu")
    paddle.seed(cfg["seed"])
    model = _rnnlm_model(paddle, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    opt = paddle.optimizer.SGD(
        learning_rate=cfg["lr"], parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(cfg["clip"]))
    stream = _rnnlm_stream(cfg, 2 * B * T + 1, cfg["seed"] + 1)
    data = paddle.reshape(paddle.to_tensor(stream[:B * T + 1][:-1]),
                          [B, T])
    label = paddle.reshape(paddle.to_tensor(stream[1:B * T + 1]), [B, T])
    states = _rnnlm_zero_states(paddle, cfg, B)

    def step():
        nonlocal states
        logits, new = model(data, states)
        loss = F.cross_entropy(paddle.reshape(logits, [-1, V]),
                               paddle.reshape(label, [-1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        states = tuple(s.detach() for s in new)     # truncated BPTT
        return loss.item()

    model.train()
    with dispatch.census() as census:
        warmup = [step() for _ in range(cfg["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    losses, step_s = [], []
    for _ in range(cfg["steps"]):
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_med = statistics.median(step_s)

    # an eval pass on the next batch: perplexity = exp(mean loss)
    model.eval()
    with paddle.no_grad():
        ev = paddle.reshape(paddle.to_tensor(stream[B * T:2 * B * T]),
                            [B, T])
        ev_label = paddle.reshape(paddle.to_tensor(
            stream[B * T + 1:2 * B * T + 1]), [B, T])
        logits, _ = model(ev, _rnnlm_zero_states(paddle, cfg, B))
        ev_loss = F.cross_entropy(paddle.reshape(logits, [-1, V]),
                                  paddle.reshape(ev_label, [-1]))
        ppl = float(paddle.exp(paddle.mean(ev_loss)))

    # beam search over the trained LM's own cells
    _zero_train_counts()
    dec = paddle.nn.BeamSearchDecoder(
        _beam_cell(paddle, list(model.lstm.cells)), cfg["start"], cfg["end"],
        cfg["beam"], embedding_fn=model.embedding, output_fn=model.fc)
    zs = [(paddle.zeros([cfg["beam_B"], cfg["hidden"]]),
           paddle.zeros([cfg["beam_B"], cfg["hidden"]]))
          for _ in range(cfg["layers"])]
    paddle.nn.dynamic_decode(dec, zs, max_step_num=2, return_length=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, _, lengths = paddle.nn.dynamic_decode(
        dec, zs, max_step_num=cfg["max_step_num"], return_length=True)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    beam_counts = _train_counts()
    n_steps = seqs.shape[1]
    yard = _lstm_yardstick(model, cfg, dev)

    flat = [d for calls in census.values() for ins, outs in calls
            for d in ins + outs]
    float_dtypes = sorted({d for d in flat if "float" in d})
    n_ops = sum(len(calls) for calls in census.values())
    out = {"phase": "train_rnnlm",
           "model": "Zaremba et al. 2014 large PTB LSTM LM",
           "config": {k: cfg[k] for k in ("vocab", "hidden", "layers", "T",
                                           "B", "dropout", "init", "lr",
                                           "clip")},
           "params": n_params, "dtype": "float32",
           "data": "seeded synthetic Zipf(1.1) stream (PTB is not in the "
                   "repository)",
           "warmup_losses": warmup, "losses": losses,
           "ln_vocab": float(np.log(V)),
           "step_ms": [1e3 * t for t in step_s],
           "step_ms_median": 1e3 * step_med,
           "tokens_per_s": B * T / step_med, **yard,
           "ops_per_step": n_ops,
           "ops_by_name": {k: len(v) for k, v in census.items()},
           "census_float_dtypes": float_dtypes,
           "eval_loss": float(ev_loss), "eval_ppl": ppl,
           "beam": {"B": cfg["beam_B"], "beam": cfg["beam"],
                    "max_step_num": cfg["max_step_num"],
                    "shape": list(seqs.shape), "steps": n_steps,
                    "ms": 1e3 * beam_s, "step_ms": 1e3 * beam_s / n_steps,
                    "lengths_max": int(lengths.max()),
                    "ids_min": int(seqs.min()), "ids_max": int(seqs.max())},
           "peak_mem_gb": peak_gb,
           "launches": counts, "beam_launches": beam_counts}
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
          and abs(warmup[0] - float(np.log(V))) <= 0.5
          and float_dtypes == ["float32"]
          and not any(counts.values()) and not any(beam_counts.values())
          and seqs.dtype == torch.int32
          and tuple(seqs.shape[::2]) == (cfg["beam_B"], cfg["beam"])
          and n_steps <= cfg["max_step_num"] + 1
          and 0 <= int(seqs.min()) and int(seqs.max()) < V
          and int(lengths.max()) <= n_steps and np.isfinite(ppl))
    out["ok"] = bool(ok)
    emit(out)
    if not ok:
        paddle.set_device(prev)
        raise AssertionError("train_rnnlm phase failed: " + json.dumps(out))
    if profile:
        model.train()
        emit({"phase": "profile_train_rnnlm", **_profile(
            step, {"matmul": MATMUL_NAMES,
                   "elementwise_and_reductions": ("elementwise", "reduce"),
                   "copies": ("copy", "cat", "memcpy", "memset")})})
    paddle.set_device(prev)
    del model, opt, dec
    torch.cuda.empty_cache()
    return out


# --- phase 19: a Paddle user's nn.Layer script trains Llama-3-8B's widths -

TRAIN_LAYER = dict(layers=4, B=2, S=4096, steps=5, lr=1e-3, seed=0,
                   prompt=64, new_tokens=8, small_S=256)
# the sweep of this slice's functions and layers, card against CPU in f32:
# sums in other orders and transcendentals a few ulps apart
SWEEP_TOL = (1e-5, 1e-5)


def _layer_sweep_cases(F, nn):
    """{name: (make, input shapes)}: ``make()`` builds the call on the CPU
    (a layer, or a function of the inputs); every function and layer this
    slice added, at small shapes."""
    g = lambda fn, **kw: lambda: (lambda *a: fn(*a, **kw))  # noqa: E731
    acts = ["relu", "relu6", "leaky_relu", "elu", "selu", "celu", "gelu",
            "sigmoid", "hardsigmoid", "hardswish", "hardtanh", "hardshrink",
            "softshrink", "tanhshrink", "silu", "swish", "mish", "softplus",
            "softsign", "thresholded_relu", "log_sigmoid", "softmax",
            "log_softmax", "tanh", "gumbel_softmax", "glu"]
    cases = {f"F.{a}": (g(getattr(F, a)), [(4, 6, 8)]) for a in acts}
    cases["F.maxout"] = (g(F.maxout, groups=2), [(4, 6, 8)])
    for mode, size, corners in (("nearest", [13, 7], False),
                                ("bilinear", [5, 13], False),
                                ("bilinear", [13, 5], True),
                                ("bicubic", [5, 17], False),
                                ("area", [4, 3], False)):
        cases[f"F.interpolate.{mode}.{size}.{corners}"] = (
            g(F.interpolate, size=size, mode=mode, align_corners=corners),
            [(2, 3, 9, 8)])
    cases.update({
        "F.interpolate.trilinear": (g(F.interpolate, size=[3, 7, 5],
                                      mode="trilinear",
                                      data_format="NCDHW"),
                                    [(1, 2, 4, 5, 6)]),
        "F.pad.reflect": (g(F.pad, pad=[1, 2, 2, 1], mode="reflect"),
                          [(2, 3, 5, 6)]),
        "F.zeropad2d": (g(F.zeropad2d, padding=[1, 2, 0, 3]), [(2, 3, 4, 5)]),
        "F.unfold": (g(F.unfold, kernel_sizes=[2, 3], strides=1,
                       paddings=1), [(2, 3, 6, 7)]),
        "F.fold": (g(F.fold, output_sizes=[5, 6], kernel_sizes=[2, 3],
                     paddings=1), [(2, 18, 36)]),
        "F.pixel_shuffle": (g(F.pixel_shuffle, upscale_factor=2),
                            [(2, 8, 3, 4)]),
        "F.pixel_unshuffle": (g(F.pixel_unshuffle, downscale_factor=2),
                              [(2, 3, 4, 6)]),
        "F.channel_shuffle": (g(F.channel_shuffle, groups=3),
                              [(2, 6, 3, 4)]),
        "F.bilinear": (g(F.bilinear), [(4, 3), (4, 5), (2, 3, 5), (2,)]),
        "F.cosine_similarity": (g(F.cosine_similarity), [(4, 6), (4, 6)]),
        "F.label_smooth": (g(F.label_smooth, epsilon=0.2), [(3, 5)]),
        "F.diag_embed": (g(F.diag_embed, offset=1), [(2, 3, 4)]),
        "F.instance_norm": (g(F.instance_norm), [(2, 3, 4, 5)]),
        "F.group_norm": (g(F.group_norm, num_groups=2), [(2, 4, 3, 5)]),
        "F.normalize": (g(F.normalize), [(3, 4, 5)]),
        "F.local_response_norm": (g(F.local_response_norm, size=3),
                                  [(2, 5, 3, 4)]),
        "F.adaptive_max_pool2d": (g(F.adaptive_max_pool2d,
                                    output_size=[3, 2]), [(2, 3, 7, 5)]),
        "F.max_unpool2d": (lambda: (lambda x: F.max_unpool2d(
            *F.max_pool2d(x, 2, return_mask=True), 2)), [(2, 3, 6, 8)]),
        "F.affine_grid": (g(F.affine_grid, out_shape=[2, 3, 5, 4],
                            align_corners=False), [(2, 2, 3)]),
        "F.grid_sample.bilinear.reflection": (
            lambda: (lambda x: F.grid_sample(x, _sweep_grid(x),
                                             padding_mode="reflection",
                                             align_corners=False)),
            [(2, 3, 5, 6)]),
        "F.grid_sample.nearest.zeros": (
            lambda: (lambda x: F.grid_sample(x, _sweep_grid(x),
                                             mode="nearest")),
            [(2, 3, 5, 6)]),
        "F.temporal_shift": (g(F.temporal_shift, seg_num=3),
                             [(6, 8, 3, 4)]),
        "nn.PReLU": (lambda: nn.PReLU(3, device="cpu"), [(2, 3, 4)]),
        "nn.Bilinear": (lambda: nn.Bilinear(3, 4, 5, device="cpu"),
                        [(6, 3), (6, 4)]),
        "nn.Upsample": (lambda: nn.Upsample(scale_factor=2,
                                            mode="bilinear"),
                        [(2, 3, 4, 5)]),
        "nn.UpsamplingBilinear2D": (lambda: nn.UpsamplingBilinear2D([7, 9]),
                                    [(2, 3, 4, 5)]),
        "nn.PairwiseDistance": (lambda: nn.PairwiseDistance(), [(4, 6),
                                                                (4, 6)]),
        "nn.Softmax2D": (lambda: nn.Softmax2D(), [(2, 3, 4, 5)]),
        "nn.InstanceNorm2D": (lambda: nn.InstanceNorm2D(3, device="cpu"),
                              [(2, 3, 4, 5)]),
        "nn.GroupNorm": (lambda: nn.GroupNorm(2, 4, device="cpu"),
                         [(2, 4, 3, 3)]),
        "nn.LocalResponseNorm": (lambda: nn.LocalResponseNorm(3),
                                 [(2, 5, 3, 3)]),
        "nn.SpectralNorm": (lambda: nn.SpectralNorm([4, 6], 0, 2,
                                                    device="cpu"),
                            [(4, 6)]),
        "nn.AdaptiveMaxPool3D": (lambda: nn.AdaptiveMaxPool3D(2),
                                 [(1, 2, 4, 5, 4)]),
        "nn.MaxUnPool1D": (lambda: (lambda x: nn.MaxUnPool1D(2)(
            *F.max_pool1d(x, 2, return_mask=True))), [(2, 3, 8)]),
        "nn.Pad3D": (lambda: nn.Pad3D([1, 0, 1, 1, 0, 2], mode="replicate"),
                     [(1, 2, 3, 4, 5)]),
        "nn.Fold": (lambda: nn.Fold([4, 5], 2), [(2, 12, 12)]),
    })
    for name in ("CELU", "GELU", "Hardswish", "LogSoftmax", "Mish", "Silu",
                 "Softplus", "ThresholdedReLU", "Tanh"):
        cases[f"nn.{name}"] = ((lambda n: lambda: getattr(nn, n)())(name),
                               [(4, 6)])
    return cases


def _sweep_grid(x):
    """A fixed (N, 4, 7, 2) grid over [-1.4, 1.4], on x's device."""
    n = x.shape[0] * 4 * 7 * 2
    return (torch.linspace(-1.4, 1.4, n, device=x.device)
            .reshape(x.shape[0], 4, 7, 2).flip(1))


def _layer_sweep(dev):
    """Every function and layer this slice added, on small f32 tensors:
    output and input gradients on the card against the same call on the
    CPU. Returns ({case: err / limit}, failures)."""
    import copy

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    atol, rtol = SWEEP_TOL
    worst, failures = {}, []
    rng = np.random.default_rng(21)
    for name, (make, shapes) in _layer_sweep_cases(F, nn).items():
        arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        cpu_fn = make()
        card_fn = (copy.deepcopy(cpu_fn).to(dev)
                   if isinstance(cpu_fn, torch.nn.Module) else cpu_fn)
        res = []
        for fn, d in ((cpu_fn, torch.device("cpu")), (card_fn, dev)):
            ts = [torch.from_numpy(a).to(d).requires_grad_(True)
                  for a in arrays]
            out = fn(*ts)
            gout = torch.ones_like(out)
            grads = torch.autograd.grad(out, ts, gout, allow_unused=True)
            res.append([out] + [torch.zeros_like(t) if gr is None else gr
                                for gr, t in zip(grads, ts)])
        ratio = 0.0
        for a, b in zip(*res):
            lim = atol + rtol * a.detach().abs()
            ratio = max(ratio, float(((b.detach().cpu() - a.detach())
                                      .abs() / lim).max()))
        worst[name] = ratio
        if not ratio <= 1.0:
            failures.append(name)
    return worst, failures


def _small_layer_step(dev, state, cfg, tokens, labels):
    """One eager step (``F.cross_entropy``, ``loss.backward()``, AdamW,
    ``clear_grad``) of the small f32 Llama on ``dev`` from ``state``: the
    loss and the parameters after it, on the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.nlp import (LlamaForCausalLM,
                                             load_numpy_state_dict)

    model = load_numpy_state_dict(LlamaForCausalLM(cfg, device=dev), state)
    opt = paddle.optimizer.AdamW(learning_rate=TRAIN_REF["lr"],
                                 parameters=model.parameters())
    logits = model(tokens.to(dev))
    loss = paddle.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), labels.to(dev).reshape(-1))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.detach()), {k: v.detach().cpu() for k, v in
                                  model.state_dict().items()}


def _layer_card_vs_cpu(dev):
    """The slice's correctness on the card against the CPU: the small f32
    Llama's eager step (the grouped flash kernels in f32 at S=256) under
    ``TRAIN_REF``, a narrow f32 ``generate`` token for token, and one
    eager step of ``MoEForCausalLM(MoEConfig.tiny())`` moving every
    tensor. Returns (readings, ok)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             load_numpy_state_dict)
    from paddle_tpu_torch.models.nlp.moe import MoEConfig, MoEForCausalLM

    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=4,
                           kv_heads=2)
    state = {k: v.numpy() for k, v in
             LlamaForCausalLM(cfg, device="cpu", seed=31).state_dict()
             .items()}
    rng = np.random.default_rng(32)
    tokens, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, TRAIN_LAYER["small_S"]))) for _ in range(2))
    attn, _, _ = _counters()
    _zero_train_counts()
    card = _small_layer_step(dev, state, cfg, tokens, labels)
    small_launches = {p: getattr(attn["gqa"], f"launches_{p}")
                      for p in ("fwd", "dq", "dkv")}
    cpu = _small_layer_step(torch.device("cpu"), state, cfg, tokens, labels)
    loss_diff = abs(card[0] - cpu[0])
    param_max, param_frac = 0.0, 0.0
    for k, want in cpu[1].items():
        d = (card[1][k] - want).abs()
        param_max = max(param_max, float(d.max()))
        param_frac = max(param_frac,
                         float((d > TRAIN_REF["param"]).float().mean()))
    step_ok = (loss_diff <= TRAIN_REF["loss"]
               and param_frac <= TRAIN_REF["param_frac"]
               and param_max <= TRAIN_REF["lr"]
               and small_launches == {"fwd": 2, "dq": 2, "dkv": 2})

    narrow = LlamaConfig.tiny(vocab=128, hidden=64, layers=2, heads=4,
                              kv_heads=2)
    nstate = {k: v.numpy() for k, v in LlamaForCausalLM(
        narrow, device="cpu", seed=33).state_dict().items()}
    prompt = torch.from_numpy(rng.integers(0, narrow.vocab_size, (2, 12)))
    gens = [load_numpy_state_dict(LlamaForCausalLM(narrow, device=d),
                                  nstate).generate(prompt.to(d), 8).cpu()
            for d in (dev, torch.device("cpu"))]
    gen_ok = bool(torch.equal(*gens))

    mcfg = MoEConfig.tiny()
    moe = MoEForCausalLM(mcfg, device=dev, seed=34,
                         generator=paddle.core.Generator(35))
    before = {k: v.detach().clone() for k, v in moe.state_dict().items()}
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=moe.parameters())
    ids = torch.from_numpy(rng.integers(0, mcfg.vocab_size, (2, 16))).to(dev)
    lab = torch.from_numpy(rng.integers(0, mcfg.vocab_size, (2, 16))).to(dev)
    loss = paddle.nn.functional.cross_entropy(
        moe(ids).reshape(-1, mcfg.vocab_size), lab.reshape(-1)) \
        + moe.aux_loss()
    loss.backward()
    opt.step()
    opt.clear_grad()
    moved = sum(not torch.equal(v, before[k])
                for k, v in moe.state_dict().items())
    moe_ok = moved == len(before) == 20
    return ({"small_step": {"config": {"hidden": 256, "heads": 4,
                                       "kv_heads": 2, "layers": 2,
                                       "S": TRAIN_LAYER["small_S"]},
                            "loss_card": card[0], "loss_cpu": cpu[0],
                            "loss_diff": loss_diff,
                            "param_max_diff": param_max,
                            "param_frac_over_atol": param_frac,
                            "gqa_launches": small_launches,
                            "tol": TRAIN_REF, "ok": step_ok},
             "generate": {"tokens_card": gens[0].tolist(),
                          "identical": gen_ok},
             "moe_step": {"moved": moved, "tensors": len(before),
                          "ok": moe_ok}},
            step_ok and gen_ok and moe_ok)


def phase_train_layer(dev):
    """A Paddle user's ``nn.Layer`` script: ``LlamaForCausalLM`` of
    Llama-3-8B at 4 of its 32 layers inside the user's own ``Layer``,
    forward hooks counting calls, 5 eager AdamW steps on
    ``F.cross_entropy``; then ``state_dict`` / ``set_state_dict`` and
    ``generate``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.nlp.llama_functional import layer_keys
    from paddle_tpu_torch.nn import functional as F

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sweep, sweep_failures = _layer_sweep(dev)
    checks, checks_ok = _layer_card_vs_cpu(dev)
    c = TRAIN_LAYER
    B, S, L, steps = c["B"], c["S"], c["layers"], c["steps"]
    prev = paddle.resolve_device(None)      # put back after the phase
    paddle.set_device("gpu")
    paddle.seed(c["seed"])
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=L)
    V = cfg.vocab_size

    class LM(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.llama = LlamaForCausalLM(cfg, seed=c["seed"])

        def forward(self, ids):
            return self.llama(ids)

    model = LM()
    calls = {"pre": 0, "post": 0}
    model.register_forward_pre_hook(
        lambda layer, inputs: calls.__setitem__("pre", calls["pre"] + 1))
    model.register_forward_post_hook(
        lambda layer, inputs, out: calls.__setitem__("post",
                                                     calls["post"] + 1))
    n_params = sum(p.numel() for p in model.parameters())
    opt = paddle.optimizer.AdamW(learning_rate=c["lr"],
                                 parameters=model.parameters(),
                                 multi_precision=True)
    rng = np.random.default_rng(c["seed"] + 1)
    ids = paddle.to_tensor(rng.integers(0, V, (B, S)))
    labels = paddle.to_tensor(rng.integers(0, V, (B, S)))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def step():
        logits = model(ids)
        loss = F.cross_entropy(logits.reshape([-1, V]),
                               labels.reshape([-1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.detach())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: 0 for k in counts}
    want.update({f"gqa_{p}": L * steps for p in ("fwd", "dq", "dkv")})
    moved = sum(not torch.equal(v, init[k])
                for k, v in model.state_dict().items())
    del init
    hook_calls = dict(calls)
    hooks_ok = hook_calls == {"pre": steps, "post": steps}

    # the state dict: the reference's keys; a round trip, bit for bit
    keys = list(model.llama.state_dict())
    want_keys = (["model.embed_tokens.weight"]
                 + [f"model.layers.{i}.{k}" for i in range(L)
                    for k in layer_keys(cfg)]
                 + ["model.norm.weight", "lm_head.weight"])
    probe = ids[:1, :256]
    with paddle.no_grad():
        before = model(probe)
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        for p in model.parameters():
            p.mul_(0.5)
        missing, unexpected = model.set_state_dict(saved)
        round_trip = bool(torch.equal(model(probe), before))
    del saved, before
    # generate: greedy, no cache, from a 64-token prompt
    prompt = ids[:1, :c["prompt"]]
    model.llama.generate(prompt, 1)                 # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_ids = model.llama.generate(prompt, c["new_tokens"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    step_med = statistics.median(step_s)
    flops, matmul_params = _step_flops(cfg, B, S)
    out = {"phase": "train_layer",
           "model": "Llama-3-8B widths (LlamaConfig.llama3_8b)",
           "layers": L, "layers_full": 32,
           "cut": f"{L} of 32 decoder layers, full width",
           "script": "class LM(paddle.nn.Layer) holding LlamaForCausalLM; "
                     "paddle.set_device('gpu'); forward pre- and post-hooks;"
                     " optimizer.AdamW(parameters=model.parameters(), "
                     "multi_precision=True); F.cross_entropy; "
                     "loss.backward(); opt.step(); opt.clear_grad()",
           "params": n_params, "dtype": "bfloat16", "B": B, "S": S,
           "steps": steps, "lr": c["lr"], "losses": losses,
           "step_ms": [1e3 * t for t in step_s],
           "step_ms_median": 1e3 * step_med,
           "tokens_per_s": B * S / step_med, "step_flops": flops,
           "mfu": flops / step_med / BF16_FLOP_PER_S,
           "peak_mem_gb": peak_gb, "launches": counts,
           "launches_expected": want, "hook_calls": hook_calls,
           "params_moved": moved, "param_tensors": len(keys),
           "state_dict_keys_ok": keys == want_keys,
           "set_state_dict": {"missing": missing, "unexpected": unexpected,
                              "logits_bit_equal": round_trip},
           "generate": {"prompt": c["prompt"], "new": c["new_tokens"],
                        "ms": 1e3 * gen_s,
                        "tokens_per_s": c["new_tokens"] / gen_s,
                        "shape": list(out_ids.shape)},
           "sweep_worst_err_over_tol": max(sweep.values()),
           "sweep_worst_case": max(sweep, key=sweep.get),
           "sweep_cases": len(sweep), "sweep_failures": sweep_failures,
           "sweep_tol": SWEEP_TOL, "card_vs_cpu": checks,
           "seconds": time.perf_counter() - t_phase}
    ok = (counts == want and all(np.isfinite(losses))
          and losses[-1] < losses[0] and moved == len(keys)
          and hooks_ok and keys == want_keys and not missing
          and not unexpected and round_trip
          and tuple(out_ids.shape) == (1, c["prompt"] + c["new_tokens"])
          and not sweep_failures and checks_ok)
    out["ok"] = bool(ok)
    emit(out)
    paddle.set_device(prev)
    del model, opt
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("train_layer phase failed: " + json.dumps(
            {k: v for k, v in out.items() if k != "card_vs_cpu"}))
    return out


# the reference phase: the op sweep and the RNNs, card against CPU ----------

def _op_cases():
    """``tests/torch_op_cases.py`` (numpy only), from the checkout."""
    import os
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module("torch_op_cases")


def _card_canonical(cid, outs):
    """Outputs whose form the card's solvers may choose otherwise than
    LAPACK's, made comparable: eigenvector and Q columns and singular
    vectors up to sign, eigenvalues of ``eig`` sorted, and ``lstsq``'s
    solution alone (the card's solver gives no residuals, rank or
    singular values)."""
    name = cid.split("[")[0]

    def signs(m):
        return np.sign(m[np.abs(m).argmax(0), np.arange(m.shape[1])])
    if name == "eigh":
        (w, wt), (v, vt) = outs
        return [(w, wt), (v * signs(v), vt)]
    if name == "qr":
        (q, qt), (r, rt) = outs
        s = signs(q)
        return [(q * s, qt), (r * s[:, None], rt)]
    if name in ("eig", "eigvals"):
        return [(np.sort_complex(outs[0][0]), outs[0][1])]
    if name == "lstsq":
        return outs[:1]
    return outs


def op_sweep(dev):
    """Every case of ``torch_op_cases`` through the port's ops on ``dev``
    against the port on the CPU: values (and gradients) within the
    case's tolerance; then each random op twice from one seed on
    ``dev``, equal draws. Returns (readings, failures)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import ops

    oc = _op_cases()
    prev = paddle.resolve_device(None)      # put back at the end
    worst = {"exact": 0.0, "f32": 0.0, "trans": 0.0, "grad": 0.0}
    failures, resigned = {}, []
    for cid in sorted(oc.CASES):
        grad = oc.wants_grad(cid)
        try:
            paddle.set_device(dev)
            got, got_g = oc.run_port(ops, cid, dev, grad)
            paddle.set_device("cpu")
            want, want_g = oc.run_port(ops, cid, "cpu", grad)
            try:
                oc.compare(cid, got, want)
                same_form = True
            except AssertionError:
                same_form = False
            got, want = (_card_canonical(cid, got),
                         _card_canonical(cid, want))
            err = oc.compare(cid, got, want)
            tol = oc.CASES[cid].tol
            worst[tol] = max(worst[tol], err)
            if not same_form:
                # another sign of a vector: its gradient under the same
                # cotangent is another function's, not compared
                resigned.append(cid)
                continue
            for g, w in zip(got_g or [], want_g or []):
                atol, rtol = oc.GRAD_TOL
                e = float(np.max(np.abs(g - w) / (atol + rtol * np.abs(w)),
                                 initial=0.0))
                worst["grad"] = max(worst["grad"], e)
                assert e <= 1.0, (cid, "grad", e)
        except Exception as e:     # recorded; the phase fails on any
            failures[cid] = f"{type(e).__name__}: {str(e)[:200]}"
        finally:
            paddle.set_device(prev)
    random_ok = {}
    paddle.set_device(dev)
    try:
        for name, make in (
                ("rand", lambda: ops.rand([64])),
                ("randn", lambda: ops.randn([64])),
                ("uniform", lambda: ops.uniform([64], min=-2.0, max=3.0)),
                ("normal", lambda: ops.normal(1.0, 2.0, [64])),
                ("standard_normal", lambda: ops.standard_normal([64])),
                ("randint", lambda: ops.randint(0, 9, [64])),
                ("randint_like", lambda: ops.randint_like(
                    torch.zeros(64, device=dev), 0, 9)),
                ("randperm", lambda: ops.randperm(64)),
                ("bernoulli", lambda: ops.bernoulli(
                    torch.full((64,), 0.5, device=dev))),
                ("poisson", lambda: ops.poisson(
                    torch.full((64,), 3.0, device=dev))),
                ("multinomial", lambda: ops.multinomial(
                    torch.full((8,), 0.125, device=dev), 4))):
            paddle.seed(5)
            a = make()
            paddle.seed(5)
            b = make()
            random_ok[name] = a.device.type == "cuda" and torch.equal(a, b)
    finally:
        paddle.set_device(prev)
    for name, same in random_ok.items():
        if not same:
            failures[name] = "random draws differ from one seed"
    return {"op_cases": len(oc.CASES), "op_worst_err_over_tol": worst,
            "random_ops_reproducible": random_ok,
            "resigned_no_grad_compare": resigned,
            "op_failures": failures}, failures


def _rnn_small(dev, kind, time_major):
    """A 2-layer bidirectional stack of ``kind`` (input 16, hidden 32,
    B=4, T=6) from one seeded generator's weights, moved to ``dev``: its
    output, final states and the gradients of the input, the initial
    states and every weight under a fixed cotangent (on the CPU)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import Generator

    make = {"lstm": nn.LSTM, "gru": nn.GRU, "simple": nn.SimpleRNN}[kind]
    layer = make(16, 32, 2, direction="bidirect", time_major=time_major,
                 device="cpu", generator=Generator(3)).to(dev)
    g = torch.Generator().manual_seed(4)
    shape = (6, 4, 16) if time_major else (4, 6, 16)
    x = torch.randn(shape, generator=g).to(dev).requires_grad_(True)
    h0 = torch.randn(4, 4, 32, generator=g).to(dev).requires_grad_(True)
    c0 = torch.randn(4, 4, 32, generator=g).to(dev).requires_grad_(True)
    st = (h0, c0) if kind == "lstm" else h0
    y, fin = layer(x, st)
    outs = [y] + (list(fin) if kind == "lstm" else [fin])
    loss = sum((o * torch.randn(o.shape, generator=g).to(dev)).sum()
               for o in outs)
    ins = [x, h0] + ([c0] if kind == "lstm" else [])
    grads = torch.autograd.grad(loss, ins + list(layer.parameters()))
    return [t.detach().cpu() for t in outs + list(grads)]


def _rnnlm_small(dev, state, ids, labels, beam_inits):
    """A small f32 LM (vocab 64, hidden 32, 2 layers, dropout 0) on
    ``dev`` from ``state``: the losses of 3 SGD steps with the global-norm
    clip, the gradients of step 1, the parameters after step 3 (each on
    the CPU), then beam search (B=4, beam 3, max_step_num 7) ids."""
    import paddle_tpu_torch as paddle

    cfg = dict(RNNLM, vocab=64, hidden=32, dropout=0.0)
    prev = paddle.resolve_device(None)
    paddle.set_device(dev)
    try:
        model = _rnnlm_model(paddle, cfg)
        model.load_state_dict(state)
        opt = paddle.optimizer.SGD(
            learning_rate=TRAIN_REF["lr"], parameters=model.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(cfg["clip"]))
        ids, labels = ids.to(dev), labels.to(dev)
        states = _rnnlm_zero_states(paddle, cfg, ids.shape[0])
        losses, grads = [], None
        for i in range(3):
            logits, new = model(ids, states)
            loss = paddle.nn.functional.cross_entropy(
                logits.reshape(-1, cfg["vocab"]), labels.reshape(-1))
            loss.backward()
            if i == 0:
                grads = {k: p.grad.detach().cpu()
                         for k, p in model.named_parameters()}
            opt.step()
            opt.clear_grad()
            states = tuple(s.detach() for s in new)
            losses.append(loss.item())
        params = {k: p.detach().cpu() for k, p in model.named_parameters()}
        model.eval()
        dec = paddle.nn.BeamSearchDecoder(
            _beam_cell(paddle, list(model.lstm.cells)), 0, 1, 3,
            embedding_fn=model.embedding, output_fn=model.fc)
        inits = [tuple(t.to(dev) for t in pair) for pair in beam_inits]
        seqs, _, lengths = paddle.nn.dynamic_decode(
            dec, inits, max_step_num=7, return_length=True)
        return losses, grads, params, seqs.cpu(), lengths.cpu()
    finally:
        paddle.set_device(prev)


def _reference_rnn(dev):
    """The small bidirectional LSTM / GRU / SimpleRNN stacks in both
    ``time_major`` forms, card against CPU, outputs and gradients within
    ``RNN_REF_ATOL`` (+ the same relative); the small LM's 3 steps under
    ``TRAIN_REF`` and its beam ids and lengths identical."""
    import paddle_tpu_torch as paddle

    stacks = {}
    ok = True
    for kind in ("lstm", "gru", "simple"):
        for tm in (False, True):
            card = _rnn_small(dev, kind, tm)
            host = _rnn_small(torch.device("cpu"), kind, tm)
            err = max(float(((a - b).abs() / (RNN_REF_ATOL + RNN_REF_ATOL
                                              * b.abs())).max())
                      for a, b in zip(card, host))
            stacks[f"{kind}{'_time_major' if tm else ''}"] = err
            ok = ok and err <= 1.0
    prev = paddle.resolve_device(None)
    paddle.set_device("cpu")
    paddle.seed(21)
    state = _rnnlm_model(paddle, dict(RNNLM, vocab=64, hidden=32,
                                      dropout=0.0)).state_dict()
    paddle.set_device(prev)
    g = torch.Generator().manual_seed(22)
    ids = torch.randint(0, 64, (4, 9), generator=g)
    z = torch.zeros(4, 32)
    inits = [(z, z), (z, z)]
    card = _rnnlm_small(dev, state, ids[:, :-1], ids[:, 1:], inits)
    host = _rnnlm_small(torch.device("cpu"), state, ids[:, :-1], ids[:, 1:],
                        inits)
    lm, lm_ok = _train_agree(card[:3], host[:3])
    beam_equal = torch.equal(card[3], host[3]) and torch.equal(card[4],
                                                               host[4])
    return {"rnn_stacks_err_over_tol": stacks, "rnn_tol": RNN_REF_ATOL,
            "rnnlm_small": lm, "rnnlm_beam_ids_equal": beam_equal,
            "rnn_ok": ok and lm_ok and beam_equal}


def _reference_ops_and_rnn(dev):
    sweep, failures = op_sweep(dev)
    rnn = _reference_rnn(dev)
    return {"op_sweep": sweep, **rnn,
            "ops_ok": not failures}, not failures and rnn["rnn_ok"]


# --- phase 20: hapi fine-tuning through the shared-memory loader ----------

# fit: a Paddle user's fine-tuning script through the port's hapi: an
# io.Dataset of seeded numpy ids, DataLoader(num_workers=4,
# persistent_workers=True) over the shared-memory worker processes,
# Model.prepare(AdamW(LinearWarmup), CrossEntropyLoss, Accuracy), fit
# with EarlyStopping, ModelCheckpoint and ReduceLROnPlateau, evaluate,
# predict, and Model.load of the checkpoint into a fresh Model. The
# network: an embedding of BERT-base's vocabulary and width, 12
# nn.TransformerEncoderLayers (768, 12 heads, FFN 3072, dropout 0.1,
# post-LN), a mean pool and a 2-class head, bf16 through
# amp.decorate(level="O2") (f32 masters), B=32 x S=512. A sequence's ids
# are uniform over the vocabulary but for 1 position in 4, which holds
# an id of its class's own pool of 32 (the label a function of the ids).
# AdamW at 5e-5 after a 2-step warm-up (a first run at 2e-4 and one at
# 1e-4 with 1 marked position in 8 spiked to losses of 7.5 and 2.5 and
# ended at chance; this one ends at accuracy 1.0 in the first epoch).
FIT = dict(vocab=30522, d=768, heads=12, ffn=3072, layers=12, S=512, B=32,
           classes=2, epochs=2, steps=8, eval_batches=2, workers=4,
           lr=5e-5, warmup=2, seed=0, pool=32, marked=0.25)
# the evaluation's accuracy after fit must reach this
FIT_EVAL_ACC = 0.9
# the card-against-CPU part: a 2-layer f32 classifier at d 256, 4 heads
# (head_dim 64), S=256 (the flash gate's shape), dropout 0, 3 fit steps
# with shuffle=False (AdamW lr 1e-3) from the same weights on both. f32
# on both sides, the kernels' sums in another order than the plain
# version's: each step's loss within FIT_SMALL_LOSS_ATOL, its running
# accuracy within one sample of the batch (1 / B), the predictions within
# REF_ATOL
FIT_SMALL = dict(vocab=1024, d=256, heads=4, ffn=512, layers=2, S=256, B=8,
                 classes=2, steps=3, lr=1e-3, seed=1, pool=32, marked=0.125)
FIT_SMALL_LOSS_ATOL = 1e-4


def _fit_classifier(paddle, cfg, dropout):
    """The phase's network, a user's ``nn.Layer``, on the default
    device."""
    nn = paddle.nn

    class Classifier(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(cfg["vocab"], cfg["d"])
            layer = nn.TransformerEncoderLayer(cfg["d"], cfg["heads"],
                                               cfg["ffn"], dropout=dropout)
            self.encoder = nn.TransformerEncoder(layer, cfg["layers"])
            self.head = nn.Linear(cfg["d"], cfg["classes"])

        def forward(self, ids):
            h = self.encoder(self.embed(ids))
            return self.head(paddle.mean(h, axis=1))

    return Classifier()


def _fit_dataset(paddle, cfg, n, seed):
    """n sequences of seeded numpy ids (module comment above FIT)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, cfg["classes"], n)
    x = rng.integers(0, cfg["vocab"], (n, cfg["S"]))
    marked = rng.random((n, cfg["S"])) < cfg["marked"]
    pool = rng.integers(0, cfg["pool"], (n, cfg["S"]))
    x = np.where(marked, y[:, None] * cfg["pool"] + pool, x).astype(np.int64)

    class Tokens(paddle.io.Dataset):
        def __getitem__(self, i):
            return x[i], np.int64(y[i])

        def __len__(self):
            return n

    return Tokens()


def _fit_small_run(paddle, cfg, state, device):
    """3 fit steps of the small classifier on ``device`` from ``state``:
    (each step's (loss, accuracy), the evaluation, the predictions)."""
    paddle.set_device(device)
    try:
        net = _fit_classifier(paddle, cfg, dropout=0.0)
        net.set_state_dict(state)
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.AdamW(
            learning_rate=cfg["lr"], parameters=net.parameters()),
            paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
        steps = []

        class Record(paddle.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                steps.append((logs["loss"], float(logs["acc"])))

        model.fit(_fit_dataset(paddle, cfg, cfg["B"] * cfg["steps"], 5),
                  batch_size=cfg["B"], shuffle=False, verbose=0,
                  callbacks=[Record()])
        ev = model.evaluate(_fit_dataset(paddle, cfg, 2 * cfg["B"], 6),
                            batch_size=cfg["B"], verbose=0)
        pred = model.predict(_fit_dataset(paddle, cfg, 2 * cfg["B"], 6),
                             batch_size=cfg["B"], stack_outputs=True)[0]
        return steps, ev, pred
    finally:
        paddle.set_device("gpu")


def _fit_metrics_on_device(paddle, dev):
    """Every metric on card tensors against the same metric on host
    numpy: (all equal, readings)."""
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((96, 5)).astype(np.float32)
    label = rng.integers(0, 5, (96, 1))
    prob = rng.random(96).astype(np.float32)
    binary = rng.integers(0, 2, 96)
    card = {k: torch.from_numpy(v).to(dev)
            for k, v in dict(pred=pred, label=label, prob=prob,
                             binary=binary).items()}
    got, want = {}, {}
    for out, src in ((got, card), (want, dict(pred=pred, label=label,
                                              prob=prob, binary=binary))):
        acc = paddle.metric.Accuracy(topk=(1, 2))
        acc.update(acc.compute(src["pred"], src["label"]))
        out["acc_top1_top2"] = acc.accumulate()
        for name in ("Precision", "Recall", "Auc"):
            m = getattr(paddle.metric, name)()
            m.update(src["prob"], src["binary"])
            out[name.lower()] = m.accumulate()
        a = paddle.metric.accuracy(src["pred"], src["label"], k=2)
        out["accuracy_k2"] = float(a)
    on_card = card["pred"].device.type == "cuda"
    return on_card and got == want, {"card": got, "host": want}


def _fit_small_checks(paddle, dev, tmp):
    """Card against CPU (the small fit), the shared-memory loader against
    the synchronous one on the full run's dataset, a bf16 save / load
    round trip, and the metrics on card tensors against host numpy."""
    cfg = FIT_SMALL
    paddle.seed(cfg["seed"])
    net = _fit_classifier(paddle, cfg, dropout=0.0)
    state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    card = _fit_small_run(paddle, cfg, state, "gpu")
    host = _fit_small_run(paddle, cfg, state, "cpu")
    loss_diff = max(abs(a[0] - b[0]) for a, b in zip(card[0], host[0]))
    acc_diff = max(abs(a[1] - b[1]) for a, b in zip(card[0], host[0]))
    pred_diff = float(np.abs(card[2] - host[2]).max())
    small_ok = (len(card[0]) == len(host[0]) == cfg["steps"]
                and loss_diff <= FIT_SMALL_LOSS_ATOL
                and acc_diff <= 1.0 / cfg["B"]
                and abs(card[1]["loss"] - host[1]["loss"])
                <= FIT_SMALL_LOSS_ATOL and pred_diff <= REF_ATOL)
    # the shared-memory loader's batches against the synchronous one's
    ds = _fit_dataset(paddle, FIT, FIT["B"] * FIT["steps"], FIT["seed"] + 1)
    sync = list(paddle.io.DataLoader(ds, batch_size=FIT["B"]))
    shm = paddle.io.DataLoader(ds, batch_size=FIT["B"],
                               num_workers=FIT["workers"])
    it = iter(shm)
    shm_kind = type(it).__name__
    shm_batches = list(it)
    loader_equal = (shm_kind == "MultiprocessDataLoaderIter"
                    and len(shm_batches) == len(sync) == FIT["steps"]
                    and all(a.device.type == "cuda" and a.dtype == b.dtype
                            and torch.equal(a, b)
                            for x, y in zip(shm_batches, sync)
                            for a, b in zip(x, y)))
    # bf16 state dict through paddle.save / paddle.load
    bf = {k: v.to(dev, torch.bfloat16) for k, v in state.items()}
    path = os.path.join(tmp, "bf16.pdparams")
    paddle.save(bf, path)
    back = paddle.load(path)
    bits_equal = all(back[k].dtype == torch.bfloat16
                     and back[k].device.type == "cuda"
                     and torch.equal(back[k].view(torch.int16),
                                     v.view(torch.int16))
                     for k, v in bf.items())
    metrics_equal, metrics = _fit_metrics_on_device(paddle, dev)
    out = {"small": {"card_steps": card[0], "cpu_steps": host[0],
                     "card_eval": card[1], "cpu_eval": host[1],
                     "loss_diff": loss_diff, "acc_diff": acc_diff,
                     "pred_diff": pred_diff,
                     "loss_atol": FIT_SMALL_LOSS_ATOL,
                     "acc_atol": 1.0 / cfg["B"], "pred_atol": REF_ATOL,
                     "ok": small_ok},
           "shm_loader": {"iterator": shm_kind, "batches": len(shm_batches),
                          "equal_to_sync": loader_equal},
           "bf16_save_load_bits_equal": bits_equal,
           "metrics_card_equal_host": metrics_equal, "metrics": metrics}
    return out, small_ok and loader_equal and bits_equal and metrics_equal


def phase_fit(dev):
    """A Paddle user's fine-tuning script through hapi at BERT-base's
    widths and depth (the comment above ``FIT``): launches of the
    multi-head flash kernels counted from 0 over fit, evaluate, predict
    and the reloaded model's predictions."""
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.io import shm_channel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    cfg = FIT
    B, S = cfg["B"], cfg["S"]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        checks, checks_ok = _fit_small_checks(paddle, dev, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        paddle.seed(cfg["seed"])
        net = _fit_classifier(paddle, cfg, dropout=0.1)
        n_params = sum(p.numel() for p in net.parameters())
        sched = paddle.optimizer.lr.LinearWarmup(cfg["lr"], cfg["warmup"],
                                                 0.0, cfg["lr"])
        opt = paddle.optimizer.AdamW(learning_rate=sched,
                                     parameters=net.parameters(),
                                     weight_decay=0.01)
        net, opt = paddle.amp.decorate(net, opt, level="O2",
                                       dtype="bfloat16")
        model = paddle.Model(net)
        model.prepare(opt, paddle.nn.CrossEntropyLoss(),
                      paddle.metric.Accuracy())
        train = paddle.io.DataLoader(
            _fit_dataset(paddle, cfg, B * cfg["steps"], cfg["seed"] + 1),
            batch_size=B, shuffle=True, drop_last=True,
            num_workers=cfg["workers"], persistent_workers=True)
        evald = paddle.io.DataLoader(
            _fit_dataset(paddle, cfg, B * cfg["eval_batches"],
                         cfg["seed"] + 2),
            batch_size=B, num_workers=cfg["workers"],
            persistent_workers=True)
        saves = []
        real_save = model.save

        def timed_save(path, training=True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_save(path, training)
            saves.append({"path": os.path.basename(path),
                          "s": time.perf_counter() - t0,
                          "bytes": sum(os.path.getsize(path + ext)
                                       for ext in (".pdparams", ".pdopt")
                                       if os.path.exists(path + ext))})

        model.save = timed_save
        rec = {"step_s": [], "wait_s": [], "losses": [], "accs": [],
               "lr": [], "epochs": 0, "evals": []}

        class Timer(paddle.callbacks.Callback):
            def on_epoch_begin(self, epoch, logs=None):
                self._t = time.perf_counter()

            def on_train_batch_begin(self, step, logs=None):
                now = time.perf_counter()
                rec["wait_s"].append(now - self._t)
                self._t = now

            def on_train_batch_end(self, step, logs=None):
                now = time.perf_counter()
                rec["step_s"].append(now - self._t)
                rec["losses"].append(logs["loss"])
                rec["accs"].append(float(logs["acc"]))
                rec["lr"].append(opt.get_lr())
                self._t = now

            def on_eval_end(self, logs=None):
                rec["evals"].append({k: float(np.ravel(v)[0])
                                     for k, v in logs.items()})

            def on_epoch_end(self, epoch, logs=None):
                rec["epochs"] += 1

        early = paddle.callbacks.EarlyStopping("loss", patience=1,
                                               verbose=0)
        plateau = paddle.callbacks.ReduceLROnPlateau(patience=2,
                                                     verbose=0)
        ckpt_dir = os.path.join(tmp, "ckpt")
        ckpt = paddle.callbacks.ModelCheckpoint(save_freq=2,
                                                save_dir=ckpt_dir)
        _zero_train_counts()
        t0 = time.perf_counter()
        model.fit(train, evald, epochs=cfg["epochs"], verbose=0,
                  callbacks=[Timer(), early, plateau, ckpt])
        fit_s = time.perf_counter() - t0
        worker_pids = train._persistent_iter.pids \
            if train._persistent_iter is not None else []
        t0 = time.perf_counter()
        ev = model.evaluate(evald, verbose=0)
        eval_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = model.predict(evald)[0]
        predict_s = time.perf_counter() - t0
        n_eval = len(pred)
        # the checkpoint into a fresh Model: the same logits, bit for bit
        paddle.seed(cfg["seed"] + 9)
        fresh_net = paddle.amp.decorate(
            _fit_classifier(paddle, cfg, dropout=0.1), level="O2",
            dtype="bfloat16")
        fresh = paddle.Model(fresh_net)
        t0 = time.perf_counter()
        fresh.load(os.path.join(ckpt_dir, "final"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        again = fresh.predict(evald)[0]
        counts = _train_counts()
        reload_equal = len(again) == n_eval and all(
            a.dtype == b.dtype and a.tobytes() == b.tobytes()
            for a, b in zip(again, pred))
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        # the loader alone: one more epoch of the persistent train loader
        t0 = time.perf_counter()
        n_alone = sum(1 for _ in train)
        loader_alone_s = time.perf_counter() - t0
        for loader in (train, evald):
            if loader._persistent_iter is not None:
                loader._persistent_iter.close()
        ckpt_files = sorted(os.listdir(ckpt_dir))
        zombies = [p for p in worker_pids if _alive(p)]
    steps = len(rec["step_s"])
    fit_evals = cfg["eval_batches"] * len(rec["evals"])
    L = cfg["layers"]
    want = {k: 0 for k in counts}
    want.update({"mha_fwd": L * (steps + fit_evals + cfg["eval_batches"]
                                 + n_eval + len(again)),
                 "mha_dq": L * steps, "mha_dkv": L * steps})
    timed = rec["step_s"][1:]
    losses = rec["losses"]
    k = max(1, steps // 4)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"phase": "fit", "card": card, "config": cfg,
           "params": n_params, "param_dtype": "bfloat16 + float32 masters",
           "optimizer": f"AdamW(LinearWarmup({cfg['lr']}, "
                        f"{cfg['warmup']}, 0.0, {cfg['lr']}), "
                        "weight_decay=0.01) through amp.decorate(O2)",
           **checks, "steps": steps, "epochs_run": rec["epochs"],
           "step_ms_first": 1e3 * rec["step_s"][0],
           "step_ms_median": 1e3 * statistics.median(timed),
           "step_ms_min": 1e3 * min(timed), "step_ms_max": 1e3 * max(timed),
           "tokens_per_s": B * S / statistics.median(timed),
           "loader_wait_ms_median": 1e3 * statistics.median(
               rec["wait_s"][1:]),
           "loader_wait_ms_max": 1e3 * max(rec["wait_s"][1:]),
           "loader_wait_ms_first": 1e3 * rec["wait_s"][0],
           "loader_alone_ms_per_batch": 1e3 * loader_alone_s
           / max(1, n_alone),
           "losses": losses, "accs": rec["accs"], "lrs": rec["lr"],
           "loss_first_mean": statistics.mean(losses[:k]),
           "loss_last_mean": statistics.mean(losses[-k:]),
           "fit_evals": rec["evals"], "eval": ev,
           "eval_accuracy": float(ev["acc"]),
           "fit_s": fit_s, "eval_s": eval_s, "predict_s": predict_s,
           "checkpoint_saves": saves, "checkpoint_files": ckpt_files,
           "checkpoint_bytes": saves[-1]["bytes"] if saves else None,
           "checkpoint_save_s": [s["s"] for s in saves],
           "checkpoint_load_s": load_s,
           "reload_logits_bit_equal": reload_equal,
           "early_stopping": {"best": early.best, "wait": early.wait,
                              "stopped": model.stop_training},
           "plateau_wait": plateau._wait, "worker_pids": worker_pids,
           "workers_left_running": zombies,
           "peak_mem_gb": peak_gb, "launches": counts,
           "launches_expected": want,
           "phase_s": time.perf_counter() - t_phase}
    ok = (checks_ok and steps == cfg["epochs"] * cfg["steps"]
          and all(np.isfinite(losses))
          and out["loss_last_mean"] < out["loss_first_mean"]
          and out["eval_accuracy"] >= FIT_EVAL_ACC and reload_equal and counts == want and len(saves) == 2
          and ckpt_files == ["0.pdopt", "0.pdparams", "final.pdopt",
                             "final.pdparams"]
          and len(worker_pids) == cfg["workers"] and not zombies
          and n_alone == cfg["steps"])
    out["ok"] = ok
    out = _plain(out)
    emit(out)
    if not ok:
        raise AssertionError("fit phase failed: " + json.dumps(
            {k: v for k, v in out.items()
             if k not in ("config", "metrics", "losses", "accs", "lrs")}))
    del model, fresh, net, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _plain(obj):
    """``obj`` with numpy scalars and arrays made Python numbers and
    lists, for JSON."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (np.generic, np.ndarray)):
        return obj.tolist()
    return obj


def _alive(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


# --- main -------------------------------------------------------------------

PHASES = ("build", "kernel", "reference", "serve", "serve_engine",
          "serve_features", "serve_cluster", "serve_tiers",
          "decode_options", "train", "train_mha",
          "train_window", "train_full", "train_long", "train_moe",
          "train_encoder", "train_bert", "train_eager", "train_resnet50",
          "train_gpt",
          "transformer", "fused_decode", "train_rnnlm", "train_layer",
          "fit")


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


def _kernels_line(kern, serve, engine, features, cluster, tiers, trains,
                  card):
    kernels = []
    cases = kern.get("paged", [])
    main_case = next((c for c in cases if c["case"] == "decode/bfloat16"),
                     None)
    if main_case is not None:
        # the serve, serve_engine, serve_features, serve_cluster and
        # serve_tiers runs' launches, by the instance the kernel reported
        runs = [r for r in (serve, engine, features, cluster, tiers) if r]
        by_instance = {}
        for r in runs:
            for name, n in r["launches_by_instance"].items():
                by_instance[name] = by_instance.get(name, 0) + n
        kernels.append({
            "name": "paged_attention", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES,
            "launches": sum(r["launches"] for r in runs) if runs else None,
            "launches_by_phase": {r["phase"]: r["launches"] for r in runs},
            "int8_launches_by_phase": {r["phase"]: r["int8_launches"]
                                       for r in runs if "int8_launches" in r},
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
    # train_full, the GQA kernels there also in train_layer (its CE is
    # F.cross_entropy: 0); the GQA kernels at G = 3, S=8192 in train_long
    launches, by_phase = _phase_launches(trains, ("train", "train_full",
                                                  "train_layer"))
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
    if kern.get("gqa_moe"):
        moe_launches, moe_by_phase = _phase_launches(trains, ("train_moe",))
        kernels += _attention_entries("gqa_flash_moe", GQA_SOURCE,
                                      GQA_FWD_REPLACES, GQA_BWD_REPLACES,
                                      "gqa", kern["gqa_moe"][0],
                                      moe_launches, card, moe_by_phase)
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
        splash = _attention_entries(
            "splash", SPLASH_SOURCE, SPLASH_FWD_REPLACES,
            SPLASH_BWD_REPLACES, "splash", kern["splash"][0],
            trains.get("train_window", {}).get("launches", {}), card)
        rolled = trains.get("decode_options", {}).get("splash_launches")
        if rolled:
            # decode_options' check runs Mistral-7B's windowed forward:
            # the forward kernel once a layer, no backward
            fwd = splash[0]
            fwd["launches_by_phase"] = {
                "train_window": fwd["launches"],
                "decode_options": rolled["launches_fwd"]}
            fwd["launches"] = (fwd["launches"] or 0) \
                + rolled["launches_fwd"]
        kernels += splash
    if kern.get("block_sparse"):
        # F.block_sparse_attention's own call in the kernel phase
        c = kern["block_sparse"][0]
        kernels += _attention_entries(
            "splash_block_sparse", SPLASH_SOURCE, SPLASH_FWD_REPLACES,
            SPLASH_BWD_REPLACES, "splash", c, c["entry_launches"], card)
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
        # and at the train_eager phase's (O1 and O2 together): the same
        # shapes again
        kernels += _attention_entries(
            "flash_mha_eager", GQA_SOURCE, MHA_FWD_REPLACES,
            MHA_BWD_REPLACES, "mha", kern["mha_encoder"][0],
            trains.get("train_eager", {}).get("launches", {}), card)
        # and at the fit phase's: hapi's Model.fit / evaluate / predict
        # over the same shapes
        kernels += _attention_entries(
            "flash_mha_fit", GQA_SOURCE, MHA_FWD_REPLACES,
            MHA_BWD_REPLACES, "mha", kern["mha_encoder"][0],
            trains.get("fit", {}).get("launches", {}), card)
        # and at the transformer phase's: encoder self-attention and
        # cross-attention of Transformer-base
        kernels += _attention_entries(
            "flash_mha_transformer", GQA_SOURCE, MHA_FWD_REPLACES,
            MHA_BWD_REPLACES, "mha", kern["mha_encoder"][1],
            trains.get("transformer", {}).get("launches", {}), card)
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
    kern, serve, engine, features, cluster, tiers, trains = \
        {}, {}, {}, {}, {}, {}, {}
    seconds = {}

    def run(name, fn, *a, **k):
        """One phase, its wall seconds kept for the ``phase_seconds``
        line."""
        t0 = time.perf_counter()
        out = fn(*a, **k)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    if "build" in phases:
        run("build", phase_build)
    if "kernel" in phases:
        kern = run("kernel", phase_kernel, dev)
    if "reference" in phases:
        run("reference", phase_reference, dev)
    if "serve" in phases:
        serve = run("serve", phase_serve, dev, profile=args.profile)
        gc.collect()
        torch.cuda.empty_cache()
    if "serve_engine" in phases:
        engine = run("serve_engine", phase_serve_engine, dev)
    if "serve_features" in phases:
        features = run("serve_features", phase_serve_features, dev)
    if "serve_cluster" in phases:
        cluster = run("serve_cluster", phase_serve_cluster, dev)
    if "serve_tiers" in phases:
        tiers = run("serve_tiers", phase_serve_tiers, dev)
    if "decode_options" in phases:
        trains["decode_options"] = run("decode_options",
                                       phase_decode_options, dev)
    for phase in TRAIN_CELLS:
        if phase in phases:
            trains[phase] = run(phase, phase_train, dev, phase,
                                profile=args.profile,
                                plain_curves=args.plain_curves)
    for phase in DEPTH_CELLS:
        if phase in phases:
            trains[phase] = run(phase, phase_train_depth, dev, phase)
    if "train_moe" in phases:
        trains["train_moe"] = run("train_moe", phase_train_moe, dev,
                                  profile=args.profile)
    if "train_encoder" in phases:
        trains["train_encoder"] = run("train_encoder", phase_train_encoder,
                                      dev, profile=args.profile)
    if "train_bert" in phases:
        trains["train_bert"] = run("train_bert", phase_train_bert, dev,
                                   profile=args.profile)
    if "train_eager" in phases:
        trains["train_eager"] = run("train_eager", phase_train_eager, dev)
    if "train_resnet50" in phases:
        trains["train_resnet50"] = run("train_resnet50",
                                       phase_train_resnet50, dev,
                                       profile=args.profile)
    if "train_gpt" in phases:
        trains["train_gpt"] = run("train_gpt", phase_train_gpt, dev)
    if "transformer" in phases:
        trains["transformer"] = run("transformer", phase_transformer, dev)
    if "fused_decode" in phases:
        trains["fused_decode"] = run("fused_decode", phase_fused_decode,
                                     dev)
    if "train_rnnlm" in phases:
        trains["train_rnnlm"] = run("train_rnnlm", phase_train_rnnlm, dev,
                                    profile=args.profile)
    if "train_layer" in phases:
        trains["train_layer"] = run("train_layer", phase_train_layer, dev)
    if "fit" in phases:
        trains["fit"] = run("fit", phase_fit, dev)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit({"phase_seconds": seconds})
    print(card)
    emit({"kernels": _kernels_line(kern, serve, engine, features, cluster,
                                   tiers, trains, card)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
