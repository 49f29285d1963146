"""The Mixture-of-Experts decoder LM for the PyTorch port (ladder config
5: DeepSeekMoE / Qwen2-MoE) and its training step on one device.

Counterpart of ``paddle_tpu/models/nlp/moe.py`` (``MoEConfig`` :17,
``MoEDecoderLayer`` :87, ``MoEForCausalLM`` :130, ``moe_train_step_factory``
:187). A Llama-style decoder whose MLP is a ``MoELayer`` every
``moe_every``-th layer (a dense SwiGLU otherwise), beside an always-on
shared SwiGLU expert where ``num_shared_experts`` > 0, with the head tied
to the embedding.

The ``Layer``s hold parameters with the reference's state-dict keys
(``embed_tokens.weight``, ``layers.{i}.self_attn.q_proj.weight``,
``layers.{i}.mlp.gate.wg.weight``, ``layers.{i}.mlp.w_in`` ...,
``norm.weight``), so a reference state dict loads with
``load_numpy_state_dict``. The attention half of each layer and the
SwiGLU MLPs are Llama's layers (``LlamaAttention``, ``LlamaMLP``:
``llama_functional``'s ``attention`` and ``swiglu``): on the card the
grouped flash kernels (or multi-head ones) where the shape is
flash-eligible, e.g. a bf16 model at S >= 256.

On a mesh (``moe_train_step_factory(mesh=)``, one rank of it per
process) the reference's annotations hold (``param_shardings``): the
routed experts' ``w_in`` / ``w_out`` over "expert" and "model"
(``MoELayer.distribute``: expert parallelism), the attention and the
shared SwiGLU's projections over "model" as Llama's
(``llama_functional``'s tensor-parallel layer math), the rest replicated;
the batch over "data", with the router's global routing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.place import resolve_device
from ...incubate.distributed.models.moe import MoELayer, xavier_normal_std
from ...nn.layer.layers import Layer, LayerList
from .llama import (LlamaAttention, LlamaConfig, LlamaMLP, _Embedding,
                    _RMSNorm)


@dataclasses.dataclass
class MoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 1024
    intermediate_size: int = 2816
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 2          # every Nth layer is MoE
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    aux_loss_weight: float = 0.01
    # always-on shared experts beside the routed ones (DeepSeekMoE /
    # Qwen2-MoE); 0 = classic GShard / Switch
    num_shared_experts: int = 0
    # width of the shared SwiGLU; None = num_shared_experts x
    # intermediate_size. Qwen2-MoE's is wider than its routed experts.
    shared_expert_intermediate: int | None = None
    dispatch_mode: str = "indexed"

    @staticmethod
    def tiny():
        return MoEConfig(vocab_size=256, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=4,
                         num_experts=4, moe_every=1)

    @staticmethod
    def qwen2_57b_a14b():
        """Qwen2-57B-A14B's shape: 64 routed experts top-8 and one
        20480-wide shared expert on every layer, 28 / 4 heads."""
        return MoEConfig(vocab_size=151936, hidden_size=3584,
                         intermediate_size=2560, num_hidden_layers=28,
                         num_attention_heads=28, num_key_value_heads=4,
                         num_experts=64, top_k=8, moe_every=1,
                         num_shared_experts=1,
                         shared_expert_intermediate=20480)

    @staticmethod
    def deepseek_tiny():
        """Fine-grained routed experts and one always-on shared expert."""
        return MoEConfig(vocab_size=256, hidden_size=64,
                         intermediate_size=32, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=4,
                         num_experts=8, top_k=2, moe_every=1,
                         num_shared_experts=1)

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            dtype=torch.float32)

    def shared_intermediate(self) -> int:
        return self.shared_expert_intermediate \
            or self.intermediate_size * self.num_shared_experts


class MoEDecoderLayer(Layer):
    """x + attention(norm(x)), then + mlp(h) (+ shared_mlp(h)) with h =
    post_attention_layernorm(x); the attention and the SwiGLU MLPs are
    Llama's layers (``llama_functional``'s arithmetic)."""

    def __init__(self, config: MoEConfig, use_moe: bool, *, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        lc = config.as_llama()
        f32 = torch.float32
        self.input_layernorm = _RMSNorm(config.hidden_size, lc.rms_norm_eps,
                                        f32, dev)
        self.self_attn = LlamaAttention(lc, dev)
        self.post_attention_layernorm = _RMSNorm(config.hidden_size,
                                                 lc.rms_norm_eps, f32, dev)
        self.shared_mlp = None
        if use_moe:
            self.mlp = MoELayer(config.hidden_size, config.intermediate_size,
                                config.num_experts,
                                gate="gshard" if config.top_k == 2
                                else "switch",
                                capacity_factor=config.capacity_factor,
                                top_k=config.top_k,
                                dispatch_mode=config.dispatch_mode,
                                device=dev, generator=generator)
            if config.num_shared_experts > 0:
                self.shared_mlp = LlamaMLP(dataclasses.replace(
                    lc, intermediate_size=config.shared_intermediate()), dev)
        else:
            self.mlp = LlamaMLP(lc, dev)
        self.use_moe = use_moe

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        h = self.post_attention_layernorm(x)
        out = self.mlp(h)
        if self.shared_mlp is not None:
            out = out + self.shared_mlp(h)
        return x + out


class MoEForCausalLM(Layer):
    """The MoE decoder LM with the head tied to ``embed_tokens``; every
    parameter trains, as in the reference.

    Parameters are made in f32 on ``device`` (the default device unless
    another is asked for; ``.to(torch.bfloat16)`` casts the model, the
    reference's ``Layer.bfloat16()``) and drawn from a ``torch.Generator``
    seeded with ``seed``, by the reference's rules: the embedding N(0,
    0.02), the norms ones, every other weight XavierNormal (the
    projections and ``gate.wg`` by their (in, out); ``w_in`` / ``w_out`` by
    the 3-D fan rule, ``xavier_normal_std``). The top-1 router noise draws
    from ``generator`` (the default generator when None). Built in
    training mode, as the reference."""

    def __init__(self, config: MoEConfig, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.embed_tokens = _Embedding((config.vocab_size,
                                        config.hidden_size), torch.float32,
                                       dev)
        self.layers = LayerList([
            MoEDecoderLayer(config,
                            use_moe=(i % config.moe_every
                                     == config.moe_every - 1),
                            device=dev, generator=generator)
            for i in range(config.num_hidden_layers)])
        self.norm = _RMSNorm(config.hidden_size, config.rms_norm_eps,
                             torch.float32, dev)
        self.init_weights(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name == "embed_tokens.weight":
                p.normal_(0.0, 0.02, generator=generator)
            else:
                p.normal_(0.0, xavier_normal_std(p.shape),
                          generator=generator)

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    def hidden_states(self, input_ids):
        """The final normed hidden states (B, S, H): the head's input."""
        tokens = torch.as_tensor(input_ids, device=self.device).long()
        x = self.embed_tokens(tokens)
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)

    def forward(self, input_ids):
        """Logits (B, S, V) through the tied head."""
        return self.hidden_states(input_ids) @ self.embed_tokens.weight.T

    def aux_loss(self):
        """The MoE layers' load-balancing losses of the last forward,
        summed (in the activations' dtype) and weighted by
        ``aux_loss_weight``."""
        total = None
        for layer in self.layers:
            if layer.use_moe and layer.mlp.aux_loss is not None:
                al = layer.mlp.aux_loss
                total = al if total is None else total + al
        if total is None:
            return torch.zeros((), device=self.device)
        return total * self.config.aux_loss_weight

    def activated_params(self) -> int:
        """Parameters a token touches (MoE MFU accounting): all but the
        routed experts, plus top_k / num_experts of them."""
        total = routed = 0
        for name, p in self.state_dict().items():
            n = int(np.prod(p.shape))
            total += n
            if ".mlp.w_in" in name or ".mlp.w_out" in name:
                routed += n
        cfg = self.config
        return total - routed + routed * cfg.top_k // cfg.num_experts


def moe_loss(model: MoEForCausalLM, tokens, labels, chunked_vocab_ce=None):
    """The reference step's loss (``moe.py:216-250``): the mean f32
    log-softmax CE of the logits against position-aligned labels, or with
    ``chunked_vocab_ce`` (a chunk size) ``chunked_causal_lm_loss`` of the
    final hidden states and the tied embedding; plus ``aux_loss()`` in
    f32."""
    ce, aux = _moe_terms(model, tokens, labels, chunked_vocab_ce)
    return ce + aux


def _moe_terms(model, tokens, labels, chunked_vocab_ce=None):
    """(the mean f32 CE over these tokens, ``aux_loss()`` in f32)."""
    if chunked_vocab_ce:
        from ...ops.chunked_ce import chunked_causal_lm_loss

        ce = chunked_causal_lm_loss(model.hidden_states(tokens),
                                    model.embed_tokens.weight, labels,
                                    int(chunked_vocab_ce))
    else:
        logits = model(tokens)
        logp = torch.log_softmax(
            logits.reshape(-1, logits.shape[-1]).to(torch.float32), -1)
        ce = -torch.mean(logp.gather(-1, labels.reshape(-1, 1))[:, 0])
    return ce, model.aux_loss().to(torch.float32)


def _replay_router_noise(model, device):
    """``context_fn`` for ``torch.utils.checkpoint``: the recomputation
    draws the forward's top-1 router noise again."""
    from ...core.generator import torch_generator
    from .train_utils import replay_generators

    return replay_generators(
        torch_generator(layer.mlp.generator, device)
        for layer in model.layers if layer.use_moe)


def _spec_of(key):
    """The reference's annotation of a MoE state-dict key: the routed
    experts' (``EXPERT_SPECS``), else Llama's (the attention and SwiGLU
    projections over "model"; the embedding, norms and router
    replicated)."""
    from ...incubate.distributed.models.moe import EXPERT_SPECS
    from .llama import _spec_of as llama_spec_of
    for leaf, spec in EXPERT_SPECS.items():
        if key.endswith(".mlp." + leaf):
            return spec
    return llama_spec_of(key)


def param_shardings(model, mesh):
    """{state-dict key: spec}: one mesh axis name or None per dimension,
    the reference's annotations (``_spec_of``) with the axes the mesh
    lacks dropped (``llama.py:481-497``). ``mesh``: a
    ``distributed.Mesh`` or {axis: size}."""
    from .llama import _axes
    names = set(_axes(mesh))
    return {k: tuple(a if a in names else None for a in _spec_of(k))
            for k in model.state_dict()}


def shard_moe_state_dict(state: dict, mesh_shape: dict, rank: int):
    """Rank ``rank``'s shards of a full MoE state dict ({key: array}, the
    reference's keys and layouts) on a row-major mesh of ``mesh_shape``
    ({axis: size}): the reference's ``addressable_shards[rank]``."""
    from ...distributed.topology import coords_of, shard_of
    coords = coords_of(mesh_shape, rank)
    names = set(mesh_shape)
    return {k: shard_of(v, tuple(a if a in names else None
                                 for a in _spec_of(k)), mesh_shape, coords)
            for k, v in state.items()}


def moe_train_step_factory(model: MoEForCausalLM, mesh=None,
                           learning_rate=1e-4, weight_decay=0.01,
                           beta1=0.9, beta2=0.95, eps=1e-8, remat=False,
                           chunked_vocab_ce=None, *, device=None):
    """Returns (params, opt_state, train_step).

    ``params`` are the model's own parameters ({state-dict key: tensor},
    made trainable; no copy is held), ``opt_state`` is
    ``make_adamw_state(params)`` (f32 moments), and ``train_step(params,
    opt_state, tokens, labels) -> (params, opt_state, loss)`` runs
    ``moe_loss`` (labels position-aligned: callers shift), the backward
    and ``apply_adamw`` (the reference's per-tensor formula), IN PLACE
    (the reference's ``donate_argnums``). The model runs in the mode it
    is in: built in training mode, as the reference traces it.
    ``remat=True`` wraps the loss in ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint(forward_loss)``): the same numbers, the
    forward run twice. ``chunked_vocab_ce``: a chunk size for the fused
    head and CE (``ops/chunked_ce.py``), which never builds the (B·S, V)
    logits.

    ``mesh``: a ``distributed.build_mesh`` over "data", "sharding",
    "sep", "model" and "expert" (one rank of it per process; "pipe" above
    1 and other axes refused), the reference's layout (``moe.py:187-270``):

    * the model is cut IN PLACE to this rank's shards under
      ``param_shardings`` (the routed experts over "expert" and "model",
      the attention and shared SwiGLU over "model", the rest replicated):
      its parameters are then the rank's, and ``params`` holds them;
    * ``train_step`` takes the global batch and runs this rank's rows of
      "data" (replicated over the other axes); the MoE layers route it
      globally and run their experts where they live
      (``MoELayer.distribute``), the attention and SwiGLUs split their
      heads and columns over "model" (``llama.set_tensor_parallel_mesh``
      around the step);
    * the loss is the CE's global mean (each rank's token sum and count
      summed over "data") plus the global load-balancing loss;
    * every rank's gradient is whole over "expert" and "model" (the
      layers' ``c_identity``), and is averaged over "data", expert shards
      included; AdamW's moments are ZeRO-1 over "sharding" by
      ``train_utils.moment_dim``."""
    from torch.utils.checkpoint import checkpoint

    from .train_utils import MESH_AXES, MeshData, apply_adamw, \
        make_adamw_state

    dev = resolve_device(device)
    on = None if mesh is None else MeshData(mesh, MESH_AXES + ("expert",))
    if remat not in (True, False):
        raise ValueError(f"remat must be True or False; got {remat!r}")
    if model.device.type != dev.type:
        raise ValueError(f"the model lives on {model.device}; build it with "
                         f"device={dev}")
    specs = None
    if on is not None:
        specs = param_shardings(model, mesh)
        _distribute(model, mesh, specs)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    opt_state = make_adamw_state(params, mesh=mesh, shardings=specs)
    terms = moe_loss if on is None else _moe_terms
    tp_mesh = mesh if on is not None and mesh.shape.get("model", 1) > 1 \
        else None

    def loss_of(tokens, labels):
        if not remat:
            return terms(model, tokens, labels, chunked_vocab_ce)
        return checkpoint(terms, model, tokens, labels, chunked_vocab_ce,
                          use_reentrant=False,
                          context_fn=lambda: _replay_router_noise(model,
                                                                  dev))

    def train_step(params, opt_state, tokens, labels):
        tokens = torch.as_tensor(tokens, device=dev).long()
        labels = torch.as_tensor(labels, device=dev).long()
        if on is None:
            loss = value = loss_of(tokens, labels)
        else:
            from .llama import _TP, set_tensor_parallel_mesh
            tokens, labels = on.rows(tokens, labels)
            prev = (_TP["mesh"], _TP["axis"])
            set_tensor_parallel_mesh(tp_mesh)
            try:
                ce, aux = loss_of(tokens, labels)
            finally:
                set_tensor_parallel_mesh(*prev)
            n = labels.numel()
            loss, value = on.ratios([(ce * n, n)])
            loss, value = loss + aux, value + aux.detach()
        grads = list(torch.autograd.grad(loss, list(params.values())))
        if on is not None:
            on.average(grads)
        apply_adamw(params, grads, opt_state, learning_rate, beta1, beta2,
                    eps, weight_decay, mesh=mesh)
        return params, opt_state, value.detach()

    return params, opt_state, train_step


def _distribute(model, mesh, specs):
    """Cut ``model`` IN PLACE to this rank's shards under ``specs``: each
    parameter split over an axis of the mesh is replaced by a new one
    holding its shard, the routed experts by ``MoELayer.distribute``."""
    from ...distributed.topology import shard_of
    coords = {a: mesh.coordinate(a) for a in mesh.axis_names}
    with torch.no_grad():
        for key, p in list(model.named_parameters()):
            split = any(a is not None and mesh.shape[a] > 1
                        for a in specs[key])
            if not split or ".mlp.w_" in key:
                continue
            owner, _, leaf = key.rpartition(".")
            setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(
                shard_of(p.detach(), specs[key], mesh.shape, coords)
                .clone()))
    for layer in model.layers:
        if layer.use_moe:
            layer.mlp.distribute(mesh)
