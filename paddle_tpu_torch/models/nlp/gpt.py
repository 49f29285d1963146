"""GPT for the PyTorch port: config, model, greedy generation and the
pretraining step.

Counterpart of ``paddle_tpu/models/nlp/gpt.py`` (``GPTConfig`` :11,
``GPTBlock`` :28, ``GPTForCausalLM`` :45, ``generate`` :74,
``gpt_pretrain_step_factory`` :92). A decoder-only stack of pre-LN blocks
(``x + attn(ln_1(x))``, then ``x + dropout(fc2(gelu(fc1(ln_2(x)))))``,
exact GELU) over word and learned position embeddings, a final
LayerNorm and the head tied to the word embedding (``x @ wte.weightᵀ``).
Built from the port's ``nn`` layers with the reference's attribute
names, so ``state_dict()`` keys equal the reference's and a reference
state dict loads with ``nn.load_numpy_state_dict``. The attention always
carries the reference's additive causal mask (float32: 0 on and below
the diagonal, float32's lowest above), so it takes the plain path of
``F.scaled_dot_product_attention``, never the flash kernels, as in the
reference. ``GPTConfig()`` is GPT-2 small (12 layers, hidden 768, 12
heads, FFN 3072, 1024 positions, vocabulary padded to 50304).

Every module takes ``device`` (``cuda`` unless ``"cpu"`` is asked for)
and ``generator`` (its initial weights and its dropout draw from it; the
default generator when None).
"""
from __future__ import annotations

import dataclasses

import torch

from ... import nn as pnn
from ...core.place import resolve_device
from ...nn import functional as F
from ...ops.linalg import matmul


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=128,
                         dropout=0.0)


class GPTBlock(pnn.Layer):
    def __init__(self, c: GPTConfig, *, device=None, generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.ln_1 = pnn.LayerNorm(c.hidden_size, c.layer_norm_eps,
                                  device=device)
        self.attn = pnn.MultiHeadAttention(c.hidden_size,
                                           c.num_attention_heads, c.dropout,
                                           **kw)
        self.ln_2 = pnn.LayerNorm(c.hidden_size, c.layer_norm_eps,
                                  device=device)
        self.fc1 = pnn.Linear(c.hidden_size, c.intermediate_size, **kw)
        self.fc2 = pnn.Linear(c.intermediate_size, c.hidden_size, **kw)
        self.dropout = pnn.Dropout(c.dropout, generator=generator)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), attn_mask=mask)
        h = self.ln_2(x)
        return x + self.dropout(self.fc2(F.gelu(self.fc1(h))))


def causal_mask(S, device):
    """The reference's additive (S, S) float32 mask: 0 on and below the
    diagonal, float32's lowest above it."""
    keep = torch.ones((S, S), dtype=torch.bool, device=device).tril()
    return torch.zeros((S, S), device=device).masked_fill(
        ~keep, torch.finfo(torch.float32).min)


class GPTForCausalLM(pnn.Layer):
    """ids (B, S) -> logits (B, S, vocab)."""

    def __init__(self, config: GPTConfig, *, device=None, generator=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "generator": generator}
        self.wte = pnn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = pnn.Embedding(config.max_position_embeddings,
                                 config.hidden_size, **kw)
        self.drop = pnn.Dropout(config.dropout, generator=generator)
        self.blocks = pnn.LayerList([GPTBlock(config, **kw) for _ in
                                     range(config.num_hidden_layers)])
        self.ln_f = pnn.LayerNorm(config.hidden_size, config.layer_norm_eps,
                                  device=device)

    @property
    def device(self) -> torch.device:
        return self.ln_f.weight.device

    def forward(self, input_ids):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        mask = causal_mask(S, input_ids.device)
        for blk in self.blocks:
            x = blk(x, mask)
        return matmul(self.ln_f(x), self.wte.weight, transpose_y=True)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=16):
        """Greedy decode by recomputation, the reference's form: each new
        token is the argmax of the last position's logits over the last
        ``max_position_embeddings`` tokens. Returns (B, S + new) ids."""
        out = torch.as_tensor(input_ids, device=self.device).long()
        window_len = self.config.max_position_embeddings
        for _ in range(int(max_new_tokens)):
            logits = self.forward(out[:, -window_len:])
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
            out = torch.cat([out, nxt[:, None]], dim=1)
        return out


def _token_nll(model: GPTForCausalLM, tokens, labels):
    """Each token's float32 log-softmax cross-entropy (B, S)."""
    logits = model(tokens).to(torch.float32)
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def lm_loss(model: GPTForCausalLM, tokens, labels):
    """The loss of the reference's step (``gpt.py:120-134``): the mean
    over every token of the float32 log-softmax cross-entropy."""
    return torch.mean(_token_nll(model, tokens, labels))


def gpt_pretrain_step_factory(model: GPTForCausalLM, mesh=None,
                              learning_rate=1e-4, weight_decay=0.01,
                              beta1=0.9, beta2=0.95, eps=1e-8, *,
                              device=None):
    """Returns (params, opt_state, train_step).

    ``params`` are the model's own parameters ({state-dict key: tensor},
    made trainable; no copy is held; the tied word embedding is one
    entry), ``opt_state`` is ``make_adamw_state(params)`` (f32 moments),
    and ``train_step(params, opt_state, tokens, labels) -> (params,
    opt_state, loss)`` runs ``lm_loss``, the backward and ``apply_adamw``
    IN PLACE (the counterpart of the reference's ``donate_argnums``). The
    model runs in ``eval()`` inside the step, so dropout is off, as in
    the reference's compiled step; its mode is restored afterwards. The
    attention stays dense (the additive causal mask), as in the
    reference.

    ``mesh``: a ``distributed.build_mesh`` over "data", "sharding", "sep"
    and "model" (one rank of it per process; "pipe" above 1 and other
    axes refused), the reference's layout (``gpt.py:92-160``): the
    parameters replicated, still the model's own; ``train_step`` takes
    the global batch and runs this rank's rows of "data"; the loss is the
    global token mean (the NLL sum and the token count summed over
    "data", ``train_utils.MeshData.ratios``); gradients are averaged over
    "data"; AdamW's moments are ZeRO-1 over "sharding"."""
    from .train_utils import MeshData, apply_adamw, make_adamw_state

    dev = resolve_device(device)
    on = None if mesh is None else MeshData(mesh)
    if model.device.type != dev.type:
        raise ValueError(f"the model lives on {model.device}; build it with "
                         f"device={dev}")
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    opt_state = make_adamw_state(params) if on is None else \
        make_adamw_state(params, mesh=mesh, shardings={k: () for k in params})

    def train_step(params, opt_state, tokens, labels):
        tokens, labels = (torch.as_tensor(t, device=dev).long()
                          for t in (tokens, labels))
        was = model.training
        model.eval()
        try:
            if on is None:
                loss = value = lm_loss(model, tokens, labels)
            else:
                nll = _token_nll(model, *on.rows(tokens, labels))
                loss, value = on.ratios([(torch.sum(nll), nll.numel())])
            grads = list(torch.autograd.grad(loss, list(params.values())))
        finally:
            model.train(was)
        if on is not None:
            on.average(grads)
        apply_adamw(params, grads, opt_state, learning_rate, beta1, beta2,
                    eps, weight_decay, mesh=mesh)
        return params, opt_state, value.detach()

    return params, opt_state, train_step
