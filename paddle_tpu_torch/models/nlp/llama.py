"""Llama for the PyTorch port: config, rotary embedding, the model's
layers and its training step.

Counterpart of ``paddle_tpu/models/nlp/llama.py`` (``LlamaConfig``,
``_rope_freqs``, ``apply_rotary``, the ``Layer`` classes
``LlamaAttention``, ``LlamaMLP``, ``LlamaDecoderLayer``, ``LlamaModel``
and ``LlamaForCausalLM`` with ``generate``, ``llama.py:180-476``, and
``llama_train_step_factory``, ``llama.py:500-738``, on one device or
on a mesh of processes, with ``param_shardings`` and the tensor /
context-parallel setters, ``:85-140``, ``:481-497``). Layouts are the
reference's: every projection weight is ``(in, out)`` and is applied as
``x @ w``, and ``state_dict()`` keys equal the reference's, fused
projections included (``qkv_proj``, ``gate_up_proj``), so a reference
state dict loads with ``load_numpy_state_dict`` unchanged.

The layers' ``forward`` and the train step share one implementation of
the layer math, ``llama_functional``'s (``attention``, ``swiglu``,
``_rms``): on the card, the flash attention kernels (grouped or
multi-head), the splash kernels for a ``sliding_window`` shorter than
the sequence, and, in the train step, the fused CE kernels. Every
parameter requires grad, as in the reference; the decode and serving
factories read detached copies under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn

from ...core.place import resolve_device
from ...nn.layer.layers import (Layer, LayerList,  # noqa: F401
                                load_numpy_state_dict)


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: Any = torch.bfloat16
    fuse_attention_qkv: bool = False
    fuse_ffn_gate_up: bool = False
    sliding_window: int | None = None

    @staticmethod
    def llama3_8b():
        return LlamaConfig(vocab_size=128256, hidden_size=4096,
                           intermediate_size=14336, num_hidden_layers=32,
                           num_attention_heads=32, num_key_value_heads=8,
                           rope_theta=500000.0)

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2):
        return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                           intermediate_size=hidden * 2,
                           num_hidden_layers=layers,
                           num_attention_heads=heads,
                           num_key_value_heads=kv_heads,
                           max_position_embeddings=512, dtype=torch.float32)


def _rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim, theta, device):
    """The f32 frequencies on ``device``, copied there once, not once per
    layer and step."""
    return torch.as_tensor(_rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rotary(x, positions, theta):
    """x: (..., seq, heads, head_dim); positions broadcast against the
    seq axis. Computed in f32 and cast back to x's dtype, as the
    reference does."""
    head_dim = x.shape[-1]
    freqs = _rope_freqs_on(head_dim, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class _Weight(Layer):
    """One named, trainable ``weight`` parameter, so module paths spell the
    reference's state-dict keys (``...q_proj.weight``). Made empty: the
    owning model fills it (``init_llama_weights``)."""

    def __init__(self, shape, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, dtype=dtype,
                                               device=device))


class _Embedding(_Weight):
    """The token embedding (V, H): rows at the ids."""

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


class _RMSNorm(_Weight):
    """``llama_functional._rms``: normalised in f32, rounded to x's dtype
    before the weight multiply, as the reference's ``nn.RMSNorm``."""

    def __init__(self, size, eps, dtype, device):
        super().__init__((size,), dtype, device)
        self.eps = eps

    def forward(self, x):
        from .llama_functional import _rms
        return _rms(x, self.weight, self.eps)


@torch.no_grad()
def init_llama_weights(layer, generator: torch.Generator):
    """Norms ones, every other weight N(0, 0.02) from ``generator``, in
    ``named_parameters`` order."""
    for name, p in layer.named_parameters():
        if name.endswith("norm.weight"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=generator)


def _seeded(layer, seed, device):
    init_llama_weights(layer, torch.Generator(device=device).manual_seed(
        seed))


class LlamaAttention(Layer):
    """q, k, v and o projections (``qkv_proj`` under
    ``fuse_attention_qkv``), (in, out) each; ``forward(x, positions)`` is
    ``llama_functional.attention`` of the normed input x: the rotary at
    ``positions`` and the causal attention, on the card through the
    flash / grouped-flash / splash kernels."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        c = self.config = config
        dev = resolve_device(device)
        H = c.hidden_size
        kv_out = c.num_key_value_heads * (H // c.num_attention_heads)
        if c.fuse_attention_qkv:
            # one (H, H + 2*kv) product, sliced q, k, v (llama.py:195-199)
            self.qkv_proj = _Weight((H, H + 2 * kv_out), c.dtype, dev)
        else:
            self.q_proj = _Weight((H, H), c.dtype, dev)
            self.k_proj = _Weight((H, kv_out), c.dtype, dev)
            self.v_proj = _Weight((H, kv_out), c.dtype, dev)
        self.o_proj = _Weight((H, H), c.dtype, dev)
        _seeded(self, seed, dev)

    def forward(self, x, positions=None):
        from .llama_functional import attention
        return attention(self.config, dict(self.named_parameters()), x,
                         positions, prefix="")


class LlamaMLP(Layer):
    """The SwiGLU MLP: gate, up (``gate_up_proj`` under
    ``fuse_ffn_gate_up``) and down projections (``llama_functional
    .swiglu``)."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        c = self.config = config
        dev = resolve_device(device)
        H, F = c.hidden_size, c.intermediate_size
        if c.fuse_ffn_gate_up:
            # one (H, 2F) product, sliced gate, up (llama.py:388-390)
            self.gate_up_proj = _Weight((H, 2 * F), c.dtype, dev)
        else:
            self.gate_proj = _Weight((H, F), c.dtype, dev)
            self.up_proj = _Weight((H, F), c.dtype, dev)
        self.down_proj = _Weight((F, H), c.dtype, dev)
        _seeded(self, seed, dev)

    def forward(self, x):
        from .llama_functional import swiglu
        return swiglu(self.config, dict(self.named_parameters()), x,
                      prefix="")


class LlamaDecoderLayer(Layer):
    """x + attention(norm(x)), then + mlp(norm(x)):
    ``llama_functional.layer_forward``'s arithmetic, through the
    sublayers (so their hooks run)."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        c = config
        dev = resolve_device(device)
        self.input_layernorm = _RMSNorm(c.hidden_size, c.rms_norm_eps,
                                        c.dtype, dev)
        self.self_attn = LlamaAttention(c, dev)
        self.post_attention_layernorm = _RMSNorm(c.hidden_size,
                                                 c.rms_norm_eps, c.dtype,
                                                 dev)
        self.mlp = LlamaMLP(c, dev)
        _seeded(self, seed, dev)

    def forward(self, x, positions=None):
        x = x + self.self_attn(self.input_layernorm(x), positions)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(Layer):
    """The embedding, the decoder layers and the final norm: the final
    normed hidden states (B, S, H)."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        c = self.config = config
        dev = resolve_device(device)
        self.embed_tokens = _Embedding((c.vocab_size, c.hidden_size),
                                       c.dtype, dev)
        self.layers = LayerList([LlamaDecoderLayer(c, dev)
                                 for _ in range(c.num_hidden_layers)])
        self.norm = _RMSNorm(c.hidden_size, c.rms_norm_eps, c.dtype, dev)
        _seeded(self, seed, dev)

    def forward(self, input_ids, positions=None):
        from .llama_functional import _positions
        tokens = torch.as_tensor(input_ids,
                                 device=self.norm.weight.device).long()
        positions = _positions(positions, tokens)
        x = self.embed_tokens(tokens)
        for layer in self.layers:
            x = layer(x, positions)
        return self.norm(x)


class LlamaForCausalLM(Layer):
    """The causal LM with the reference's state-dict keys:
    ``model.embed_tokens.weight`` (V, H), ``model.layers.{i}.<key>`` for
    each key of ``llama_functional.layer_keys(config)`` (projections (in,
    out); ``self_attn.qkv_proj.weight`` (H, H + 2·kv·hd) under
    ``fuse_attention_qkv``, ``mlp.gate_up_proj.weight`` (H, 2F) under
    ``fuse_ffn_gate_up``), ``model.norm.weight``, ``lm_head.weight`` (H,
    V; absent when ``tie_word_embeddings``). Every parameter trains, as
    in the reference.

    Parameters are made on ``device`` (the default device unless another
    is asked for) and filled from a ``torch.Generator`` seeded with
    ``seed`` (``init_llama_weights``: norms ones, every other weight N(0,
    0.02)); each sublayer built alone is filled the same way. Load real
    or reference weights with ``load_numpy_state_dict`` or
    ``set_state_dict``."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        if config.sliding_window is not None and config.sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1 (got "
                             f"{config.sliding_window}); use None to "
                             f"disable")
        dev = resolve_device(device)
        self.config = config
        self.model = LlamaModel(config, dev)
        self.lm_head = None if config.tie_word_embeddings else _Weight(
            (config.hidden_size, config.vocab_size), config.dtype, dev)
        self.init_weights(torch.Generator(device=dev).manual_seed(seed))

    def init_weights(self, generator: torch.Generator):
        init_llama_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device

    def forward(self, input_ids, positions=None):
        """Logits (B, S, V) for input_ids (B, S), differentiable in every
        parameter: ``llama_functional.forward``'s arithmetic through the
        layers. ``positions`` ((S,) or (B, S)) feed the rotary in place of
        0..S-1, as in the reference; the causal mask stays that of the
        sequence order."""
        h = self.model(input_ids, positions)
        if self.lm_head is None:
            return h @ self.model.embed_tokens.weight.T
        return h @ self.lm_head.weight

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 16):
        """Greedy decoding without a cache (``paddle_tpu/models/nlp/
        llama.py:465-476``): each step runs the whole sequence and appends
        the argmax of the last position's logits. Returns (B, S +
        max_new_tokens) ids in input_ids' dtype."""
        out = torch.as_tensor(input_ids, device=self.device)
        for _ in range(max_new_tokens):
            nxt = self(out)[:, -1].argmax(-1)
            out = torch.cat([out, nxt[:, None].to(out.dtype)], 1)
        return out


# --- tensor and context parallelism (llama.py:85-140) ----------------------
# The mesh whose model axis splits the heads, and the one whose "sep" axis
# splits the sequence: set by the train-step factory around its forward
# (``set_tensor_parallel_mesh``, ``set_context_parallel_mesh``);
# ``llama_functional`` then runs the layer math on this rank's shards and
# chunk.
_TP = {"mesh": None, "axis": "model"}
_CP = {"mesh": None, "axis": "sep"}


def set_tensor_parallel_mesh(mesh, axis: str = "model"):
    """The mesh whose ``axis`` splits the attention heads (None: none)."""
    _TP["mesh"] = mesh
    _TP["axis"] = axis


def _tensor_parallel_mesh():
    mesh, axis = _TP["mesh"], _TP["axis"]
    if mesh is None or mesh.shape.get(axis, 1) <= 1:
        return None, None
    return mesh, axis


def set_context_parallel_mesh(mesh, axis: str = "sep"):
    """The mesh whose ``axis`` splits the sequence over its ranks (None:
    none). Under one, each rank holds its chunk of the sequence and the
    attention runs ring, window-ring or Ulysses attention over the axis
    (``llama_functional``)."""
    _CP["mesh"] = mesh
    _CP["axis"] = axis


def _context_parallel_mesh():
    """(mesh, axis) of the context-parallel mesh set, else of the global
    mesh when its "sep" axis is above 1, else (None, None)."""
    mesh, axis = _CP["mesh"], _CP["axis"]
    if mesh is not None and mesh.shape.get(axis, 1) > 1:
        return mesh, axis
    from ...distributed.topology import get_global_mesh
    g = get_global_mesh()
    if g is not None and g.shape.get("sep", 1) > 1:
        return g, "sep"
    return None, None


# the reference's sharding annotations of the Llama layers (llama.py
# :196-226, :387-395; the mp layers' PartitionSpecs): vocabulary rows of the
# embedding, columns of the column-parallel projections and the head, rows
# of the row-parallel ones; the norms replicated
_COLUMN = ("q_proj", "k_proj", "v_proj", "qkv_proj", "gate_proj", "up_proj",
           "gate_up_proj")
_ROW = ("o_proj", "down_proj")


def _spec_of(key):
    if key == "model.embed_tokens.weight":
        return ("model", None)
    if key == "lm_head.weight":
        return (None, "model")
    layer = key.rsplit(".", 2)
    if len(layer) == 3 and layer[-1] == "weight":
        if layer[-2] in _COLUMN:
            return (None, "model")
        if layer[-2] in _ROW:
            return ("model", None)
    return ()


def _axes(mesh):
    return dict(mesh.shape) if hasattr(mesh, "shape") and isinstance(
        mesh.shape, dict) else dict(mesh)


def param_shardings(model, mesh):
    """{state-dict key: spec}: one mesh axis name or None per dimension,
    the reference's annotations with the axes the mesh lacks dropped
    (``llama.py:481-497``). ``mesh``: a ``distributed.Mesh`` or {axis:
    size}."""
    names = set(_axes(mesh))
    return {k: tuple(a if a in names else None for a in _spec_of(k))
            for k in model.state_dict()}


_FUSED = {"self_attn.qkv_proj.weight": "qkv", "mlp.gate_up_proj.weight":
          "gate_up"}


def _component_widths(cfg, key):
    """The column widths of a fused key's components (q, k, v or gate,
    up), or None."""
    kind = next((v for k, v in _FUSED.items() if key.endswith(k)), None)
    if kind == "qkv":
        H = cfg.hidden_size
        kv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
        return (H, kv, kv)
    if kind == "gate_up":
        return (cfg.intermediate_size,) * 2
    return None


def shard_llama_tensor(cfg, key, full, spec, mesh_shape, coords):
    """Rank ``coords``' shard of the full tensor ``full`` (numpy or torch)
    of ``key`` under ``spec``: the block the reference's device holds,
    except for a fused projection split over "model", which is cut by
    component (each rank's q, k and v columns, or gate and up, side by
    side) so that the rank holds whole heads."""
    from ...distributed.topology import shard_of
    widths = _component_widths(cfg, key)
    n = mesh_shape.get("model", 1)
    if widths is None or n == 1 or "model" not in spec:
        return shard_of(full, spec, mesh_shape, coords)
    parts, off = [], 0
    for w in widths:
        parts.append(shard_of(full[:, off:off + w], spec, mesh_shape,
                              coords))
        off += w
    if isinstance(full, torch.Tensor):
        return torch.cat(parts, dim=1)
    return np.concatenate(parts, axis=1)


def shard_llama_state_dict(cfg, state: dict, mesh_shape: dict, rank: int):
    """Rank ``rank``'s shards of a full Llama state dict ({key: array},
    the reference's keys and layouts) on a row-major mesh of
    ``mesh_shape`` ({axis: size}), as ``shard_llama_tensor`` cuts them."""
    from ...distributed.topology import coords_of
    coords = coords_of(mesh_shape, rank)
    names = set(mesh_shape)
    return {k: shard_llama_tensor(
        cfg, k, v, tuple(a if a in names else None for a in _spec_of(k)),
        mesh_shape, coords) for k, v in state.items()}


def llama_train_step_factory(model: LlamaForCausalLM, learning_rate=1e-4,
                             weight_decay=0.01, beta1=0.9, beta2=0.95,
                             eps=1e-8, accum_dtype=torch.float32,
                             remat: bool | str = True, device=None,
                             mesh=None, offload_moments: bool = False,
                             chunked_vocab_ce: int | None = None):
    """Returns (params, opt_state, train_step) for one device.

    ``params`` are the model's own parameters ({state-dict key: tensor},
    made trainable; no copy is held), ``opt_state`` is
    ``make_adamw_state(params, accum_dtype, offload_moments)``, and
    ``train_step(params, opt_state, tokens, labels) -> (params, opt_state,
    loss)`` runs the forward (the attention kernels of
    ``llama_functional``), the loss, the backward and AdamW. The update
    is IN PLACE: the counterpart of the reference's ``donate_argnums``,
    and the model holds the trained weights.

    remat: False keeps every activation; True checkpoints each decoder
    layer and recomputes its forward in the backward; ``"dots"`` keeps
    the projections' outputs and recomputes the rest (the reference's
    ``dots_with_no_batch_dims_saveable``). The numbers are the same; the
    attention forward launches double under True and ``"dots"``
    (``llama_functional.hidden_states``).

    offload_moments: AdamW's f32 moments live in pinned host memory and
    stream through the card in chunks of 4 tensors around the update
    (``train_utils.apply_adamw``): what a 7-8 B model needs to train on
    one 80 GB card. The result equals device-resident moments bit for
    bit.

    chunked_vocab_ce: a chunk size; the tied embedding's head and the CE
    run chunk by chunk (``ops/chunked_ce.py``), so the (B·S, V) logits are
    never built. Requires tied word embeddings (ValueError otherwise, as
    in the reference).

    mesh: a ``distributed.build_mesh`` over the axes "data", "sharding",
    "sep" and "model" (keyword only), one rank of it per process; see
    ``_mesh_step``. A "pipe" axis above 1 is refused (ROADMAP Queue 1 item
    15), and so is ``chunked_vocab_ce`` with a model axis above 1, as in
    the reference."""
    from .llama_functional import (CHUNKED_NEEDS_TIED, _check_remat,
                                   loss_fn, param_views)
    from .train_utils import apply_adamw, make_adamw_state

    dev = resolve_device(device)
    _check_remat(remat)
    if chunked_vocab_ce and model.lm_head is not None:
        raise ValueError(CHUNKED_NEEDS_TIED)
    cfg = model.config
    if model.device.type != dev.type:
        raise ValueError(f"the model lives on {model.device}; build it with "
                         f"device={dev}")
    if mesh is not None:
        return _mesh_step(model, mesh, dev, learning_rate, weight_decay,
                          beta1, beta2, eps, accum_dtype, remat,
                          offload_moments, chunked_vocab_ce)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    opt_state = make_adamw_state(params, accum_dtype, offload=offload_moments)
    n_layers = cfg.num_hidden_layers

    def train_step(params, opt_state, tokens, labels):
        tokens = torch.as_tensor(tokens, device=dev).long()
        labels = torch.as_tensor(labels, device=dev).long()
        keys = list(params)
        outer, layers = param_views(params, n_layers)
        loss = loss_fn(cfg, outer, layers, tokens, labels, remat,
                       chunked_vocab_ce)
        grads = list(torch.autograd.grad(loss, [params[k] for k in keys]))
        apply_adamw(params, grads, opt_state, learning_rate, beta1, beta2,
                    eps, weight_decay, accum_dtype, offload=offload_moments)
        return params, opt_state, loss.detach()

    return params, opt_state, train_step


def _mesh_step(model, mesh, dev, lr, weight_decay, beta1, beta2, eps,
               accum_dtype, remat, offload_moments, chunked_vocab_ce):
    """The factory on a mesh (``llama.py:500-640``), from this rank:

    * ``params`` are this rank's shards ({key: tensor}), cut from the
      model's parameters by ``param_shardings`` (``shard_llama_tensor``:
      fused projections by component), new tensors: the model keeps its
      own weights and is not trained;
    * ``train_step`` takes the global batch; the rank keeps its rows of
      "data" and its columns of "sep" (its chunk of the sequence; tokens
      and labels cut alike, no label shift, as in the reference,
      ``:595-601``); the batch is replicated over the other axes;
    * under a "sep" axis above 1 the attention runs over the axis's ranks
      (``set_context_parallel_mesh``: ring, window-ring or Ulysses
      attention, ``llama_functional._attention``) and the rotary takes the
      chunk's global positions; a model axis keeps splitting the heads
      (the reference turns its TP mesh off under "sep", ``:567-571``, and
      lets GSPMD split them: the same function);
    * the loss is the global mean: each rank's mean over its rows and
      chunk (the fused CE kernels without a model axis, the
      vocabulary-split f32 CE with one), averaged over "data" and "sep"
      (``:603-622``; the value returned);
    * gradients are averaged over "data" and "sep" (the parameters are
      replicated over both; ``train_utils.MeshData.average``, 16-bit ones
      in f32); over "sharding" the batch is replicated, so each rank's
      gradient is whole already;
    * the update is ZeRO-1 over "sharding" (``train_utils``: each rank
      updates its slice of every moment and parameter and the parameters
      are all-gathered), in pinned host memory with
      ``offload_moments``."""
    from ...distributed.collective import ReduceOp, all_reduce
    from .llama_functional import loss_fn, param_views
    from .train_utils import MeshData, apply_adamw, make_adamw_state

    shape = mesh.shape
    on = MeshData(mesh)
    has_model = shape.get("model", 1) > 1
    if chunked_vocab_ce and has_model:
        raise ValueError(
            "chunked_vocab_ce is a single-chip/vocab-replicated path; with a "
            ">1 'model' axis the vocab-sharded dense CE already avoids the "
            "(B*S, V) gather — drop the flag there")
    if chunked_vocab_ce and model.lm_head is not None:
        from .llama_functional import CHUNKED_NEEDS_TIED
        raise ValueError(CHUNKED_NEEDS_TIED)
    if model.device.type != dev.type:
        raise ValueError(f"the model lives on {model.device}; build it with "
                         f"device={dev}")
    cfg = model.config
    specs = param_shardings(model, mesh)
    coords = {a: mesh.coordinate(a) for a in mesh.axis_names}
    with torch.no_grad():
        params = {k: shard_llama_tensor(cfg, k, v.detach(), specs[k], shape,
                                        coords).clone().requires_grad_(True)
                  for k, v in model.named_parameters()}
    opt_state = make_adamw_state(params, accum_dtype, offload=offload_moments,
                                 mesh=mesh, shardings=specs)
    sp = shape.get("sep", 1)
    col = coords.get("sep", 0)
    sep = mesh.group("sep") if sp > 1 else None
    tp_mesh = mesh if has_model else None
    cp_mesh = mesh if sp > 1 else None
    n_layers = cfg.num_hidden_layers

    def train_step(params, opt_state, tokens, labels):
        tokens = torch.as_tensor(tokens, device=dev).long()
        labels = torch.as_tensor(labels, device=dev).long()
        if tokens.shape[1] % sp:
            raise ValueError(f"a sequence of {tokens.shape[1]} tokens does "
                             f"not divide over sep={sp}")
        s = tokens.shape[1] // sp
        tokens, labels = (t[:, col * s:(col + 1) * s]
                          for t in on.rows(tokens, labels))
        keys = list(params)
        prev = (_TP["mesh"], _TP["axis"], _CP["mesh"], _CP["axis"])
        set_tensor_parallel_mesh(tp_mesh)
        set_context_parallel_mesh(cp_mesh)
        try:
            outer, layers = param_views(params, n_layers)
            loss = loss_fn(cfg, outer, layers, tokens, labels, remat,
                           chunked_vocab_ce)
            grads = list(torch.autograd.grad(loss, [params[k] for k in keys]))
        finally:
            set_tensor_parallel_mesh(*prev[:2])
            set_context_parallel_mesh(*prev[2:])
        loss = loss.detach().clone()
        on.average(grads, sep)
        for group in (on.group, sep):
            if group is not None:
                all_reduce(loss, op=ReduceOp.AVG, group=group)
        apply_adamw(params, grads, opt_state, lr, beta1, beta2, eps,
                    weight_decay, accum_dtype, offload=offload_moments,
                    mesh=mesh)
        return params, opt_state, loss

    return params, opt_state, train_step
