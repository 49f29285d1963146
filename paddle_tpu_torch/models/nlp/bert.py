"""BERT for the PyTorch port: config, model, pretraining heads and the
pretraining step.

Counterpart of ``paddle_tpu/models/nlp/bert.py`` (``BertConfig`` :16,
``BertEmbeddings`` :38, ``BertModel`` :59, ``BertForPretraining`` :91,
``BertForSequenceClassification`` :126, ``bert_pretrain_step_factory``
:138). Built from the port's ``nn`` layers, with the reference's
attribute names, so ``state_dict()`` keys equal the reference's and a
reference state dict loads with ``nn.load_numpy_state_dict``. The
encoder is ``nn.TransformerEncoder``, whose layers start from one set of
weights, as the reference's do. Without an ``attention_mask`` the
attention takes the multi-head flash kernels where their gate admits the
shape (S >= 256 and a multiple of 128, head_dim 64 / 128 / 256); with
one it takes the dense additive path, the mask in float32 (a bfloat16
score plus it is a float32 sum, as in JAX).

Every module takes ``device`` (``cuda`` unless ``"cpu"`` is asked for)
and ``generator`` (its initial weights and its dropout draw from it; the
default generator when None). Dropout is drawn afresh on every call; the
reference's compiled step draws its masks once, while tracing (ROADMAP
Queue 3).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn

from ... import nn as pnn
from ...core.generator import torch_generator
from ...core.place import resolve_device
from ...nn import functional as F


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=512, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=128, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)


class BertEmbeddings(nn.Module):
    """Word + position (0..S-1) (+ token-type, when given) embeddings,
    then LayerNorm and dropout."""

    def __init__(self, c: BertConfig, *, device=None, generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.word_embeddings = pnn.Embedding(c.vocab_size, c.hidden_size,
                                             **kw)
        self.position_embeddings = pnn.Embedding(c.max_position_embeddings,
                                                 c.hidden_size, **kw)
        self.token_type_embeddings = pnn.Embedding(c.type_vocab_size,
                                                   c.hidden_size, **kw)
        self.layer_norm = pnn.LayerNorm(c.hidden_size, c.layer_norm_eps,
                                        device=device)
        self.dropout = pnn.Dropout(c.hidden_dropout_prob,
                                   generator=generator)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = self.word_embeddings(input_ids) \
            + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


def additive_mask(attention_mask):
    """(B, S) 1 = attend / 0 = padding -> the reference's additive float32
    mask (B, 1, 1, S): 0 where attended, float32's lowest elsewhere."""
    m = attention_mask.to(torch.float32)
    return ((1.0 - m) * torch.finfo(torch.float32).min)[:, None, None, :]


class BertModel(nn.Module):
    """Embeddings, the post-LN encoder, and the pooler
    ``tanh(pooler(seq[:, 0]))``. Returns (seq (B, S, H), pooled (B,
    H))."""

    def __init__(self, config: BertConfig, *, device=None, generator=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "generator": generator}
        self.embeddings = BertEmbeddings(config, **kw)
        layer = pnn.TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob, **kw)
        self.encoder = pnn.TransformerEncoder(layer,
                                              config.num_hidden_layers)
        self.pooler = pnn.Linear(config.hidden_size, config.hidden_size,
                                 **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            attention_mask = additive_mask(attention_mask)
        seq = self.encoder(x, attention_mask)
        return seq, F.tanh(self.pooler(seq[:, 0]))


class BertForPretraining(nn.Module):
    """MLM and NSP heads: MLM logits (B, S, V) = mlm_norm(act(
    mlm_transform(seq))) @ word_embeddings.weightᵀ (tied, no bias), NSP
    logits (B, 2) = nsp_head(pooled)."""

    def __init__(self, config: BertConfig, *, device=None, generator=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "generator": generator}
        self.bert = BertModel(config, **kw)
        self.mlm_transform = pnn.Linear(config.hidden_size,
                                        config.hidden_size, **kw)
        self.mlm_norm = pnn.LayerNorm(config.hidden_size,
                                      config.layer_norm_eps, device=device)
        self.nsp_head = pnn.Linear(config.hidden_size, 2, **kw)
        self.act = getattr(F, config.hidden_act)

    @property
    def device(self) -> torch.device:
        return self.nsp_head.weight.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(self.act(self.mlm_transform(seq)))
        mlm_logits = torch.matmul(
            h, self.bert.embeddings.word_embeddings.weight.t())
        return mlm_logits, self.nsp_head(pooled)

    def loss(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels,
             ignore_index=-100):
        mlm = F.cross_entropy(mlm_logits, mlm_labels,
                              ignore_index=ignore_index)
        return mlm + F.cross_entropy(nsp_logits, nsp_labels)


class BertForSequenceClassification(nn.Module):
    """classifier(dropout(pooled))."""

    def __init__(self, config: BertConfig, num_classes=2, *, device=None,
                 generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.bert = BertModel(config, **kw)
        self.dropout = pnn.Dropout(config.hidden_dropout_prob,
                                   generator=generator)
        self.classifier = pnn.Linear(config.hidden_size, num_classes, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


def pretrain_loss(model: BertForPretraining, input_ids, type_ids,
                  mlm_labels, nsp_labels):
    """The loss of the reference's pretraining step (``bert.py:165-183``),
    operation for operation: the model without an attention mask; the MLM
    logits flattened to float32, ``log_softmax`` over all B·S rows, the
    label's entry picked (class 0 for an ignored label), masked by
    ``label != -100`` and divided by max(Σ valid, 1); plus the NSP mean
    NLL in float32."""
    mlm_logits, nsp_logits = model(input_ids, type_ids)
    flat = mlm_logits.reshape(-1, mlm_logits.shape[-1]).to(torch.float32)
    lbl = mlm_labels.reshape(-1)
    valid = lbl != -100
    logp = torch.log_softmax(flat, -1)
    nll = -torch.gather(logp, -1, torch.where(valid, lbl, 0)[:, None])[:, 0]
    mlm_loss = torch.sum(nll * valid) / torch.clamp_min(torch.sum(valid), 1)
    nsp_logp = torch.log_softmax(nsp_logits.to(torch.float32), -1)
    nsp_loss = -torch.mean(
        torch.gather(nsp_logp, -1, nsp_labels[:, None])[:, 0])
    return mlm_loss + nsp_loss


def _replay_dropout(model, device):
    """``context_fn`` for ``torch.utils.checkpoint``: the recomputation
    draws the same dropout masks as the forward (the generators' states
    at the forward's start are set again, and restored after), as
    ``jax.checkpoint`` recomputes from the same keys."""
    gens = list({id(g): g for g in (
        torch_generator(m.generator, device) for m in model.modules()
        if isinstance(m, pnn.Dropout))}.values())
    saved = []

    @contextlib.contextmanager
    def forward():
        saved[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, saved):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    return forward(), recompute()


def bert_pretrain_step_factory(model: BertForPretraining, mesh=None,
                               learning_rate=1e-4, weight_decay=0.01,
                               beta1=0.9, beta2=0.999, eps=1e-8,
                               remat=False, *, device=None):
    """Returns (params, opt_state, train_step) for one device.

    ``params`` are the model's own parameters ({state-dict key: tensor},
    made trainable; no copy is held; the tied word embedding is one
    entry), ``opt_state`` is ``make_adamw_state(params)`` (f32 moments),
    and ``train_step(params, opt_state, input_ids, type_ids, mlm_labels,
    nsp_labels) -> (params, opt_state, loss)`` runs ``pretrain_loss``,
    the backward and ``apply_adamw`` (``adamw_update`` per tensor), IN
    PLACE (the
    counterpart of the reference's ``donate_argnums``). The model runs
    in the mode it is in: in ``train()`` its dropout is live, drawn anew
    each step. ``remat=True`` wraps the forward and loss in
    ``torch.utils.checkpoint`` (non-reentrant), whose recomputation
    replays the forward's dropout draws: the numbers are those of
    ``remat=False``, the attention kernels' forward launches double.

    Not ported yet, and refused: ``mesh`` (data parallel and ZeRO moment
    sharding: ROADMAP Queue 1 item 15)."""
    from .train_utils import apply_adamw, make_adamw_state

    dev = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError(
            "mesh axes (data/sharding) are not ported yet: ROADMAP Queue 1 "
            "item 15, distributed / parallel")
    if remat not in (True, False):
        raise ValueError(f"remat must be True or False; got {remat!r}")
    if model.device.type != dev.type:
        raise ValueError(f"the model lives on {model.device}; build it with "
                         f"device={dev}")
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    opt_state = make_adamw_state(params)

    def loss_of(*batch):
        if not remat:
            return pretrain_loss(model, *batch)
        from torch.utils.checkpoint import checkpoint
        return checkpoint(pretrain_loss, model, *batch, use_reentrant=False,
                          context_fn=lambda: _replay_dropout(model, dev))

    def train_step(params, opt_state, input_ids, type_ids, mlm_labels,
                   nsp_labels):
        batch = [torch.as_tensor(t, device=dev).long()
                 for t in (input_ids, type_ids, mlm_labels, nsp_labels)]
        loss = loss_of(*batch)
        grads = list(torch.autograd.grad(loss, list(params.values())))
        apply_adamw(params, grads, opt_state, learning_rate, beta1, beta2,
                    eps, weight_decay)
        return params, opt_state, loss.detach()

    return params, opt_state, train_step
