"""Fused transformer layers of the PyTorch port.

Counterpart of ``paddle_tpu/incubate/nn/__init__.py:19-118``
(``_fused_epilogue``, ``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer``, ``FusedLinear``). "Fused" means what it
means there: a post-LN layer (``normalize_before=False``) ends in the
epilogue ``LayerNorm(residual + dropout(x))`` through
``ops.dropout_ln.fused_dropout_add_layer_norm``, the dropout-add-LayerNorm
kernel on the card, differentiable through its closed-form backward; the
attention takes the flash kernels where the reference's gate admits the
shape; the matrix products are ``torch.matmul``. A pre-LN layer is the
plain composition, as in the reference.

Attribute names are the reference's (``fused_attn.attn.q_proj.weight``,
``fused_attn.ln_post.bias``, ``ffn.linear1.weight``, ``ffn.norm.weight``
...), so state-dict keys agree and ``nn.load_numpy_state_dict`` loads a
reference layer's weights. Every layer takes ``device`` (``cuda`` unless
``"cpu"`` is asked for) and ``generator`` (its initial weights and its
dropout draw from it; the default generator when None). Keyword-only
past the reference's first arguments; the ``*_attr`` arguments, ``kdim``
/ ``vdim`` / ``need_weights`` of ``FusedMultiHeadAttention``, ``nranks``
and ``ring_id`` (which the reference ignores) are not ported, nor is the
``cache`` argument. ``FusedMultiTransformer`` (``:121-280``) waits
(ROADMAP Queue 1).
"""
from __future__ import annotations

from torch import nn as _nn

from ... import nn
from ...nn import functional as F
from ...ops.dropout_ln import fused_dropout_add_layer_norm


def _fused_epilogue(x, residual, ln, p, training, generator=None):
    """LayerNorm ``ln`` of residual + dropout(x), through the fused
    kernel."""
    return fused_dropout_add_layer_norm(x, residual, ln.weight, ln.bias,
                                        p=p, eps=ln.epsilon,
                                        training=training,
                                        generator=generator)


def _no_cache(cache):
    if cache is not None:
        raise NotImplementedError("the fused layers' caches are not ported "
                                  "yet (ROADMAP Queue 1)")


class FusedMultiHeadAttention(_nn.Module):
    """Attention with its residual: pre-LN ``query + dropout(attn(
    ln_pre(query)))`` or post-LN ``ln_post(query + dropout(attn(query)))``
    (the fused epilogue)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, *, normalize_before=False,
                 epsilon=1e-5, device=None, generator=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.generator = generator
        self.attn = nn.MultiHeadAttention(embed_dim, num_heads,
                                          attn_dropout_rate, device=device,
                                          generator=generator)
        self.dropout = nn.Dropout(dropout_rate, generator=generator)
        self.ln_pre = nn.LayerNorm(embed_dim, epsilon, device=device)
        self.ln_post = nn.LayerNorm(embed_dim, epsilon, device=device)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        _no_cache(cache)
        residual = query
        if self.normalize_before:
            query = self.ln_pre(query)
        out = self.attn(query, key, value, attn_mask=attn_mask)
        if not self.normalize_before:
            return _fused_epilogue(out, residual, self.ln_post,
                                   self.dropout.p, self.training,
                                   self.generator)
        return residual + self.dropout(out)


class FusedFeedForward(_nn.Module):
    """linear2(dropout1(activation(linear1(x)))) with its residual, pre-LN
    or post-LN (the fused epilogue)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, *, device=None, generator=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.generator = generator
        kw = {"device": device, "generator": generator}
        self.linear1 = nn.Linear(d_model, dim_feedforward, **kw)
        self.linear2 = nn.Linear(dim_feedforward, d_model, **kw)
        self.dropout1 = nn.Dropout(act_dropout_rate if act_dropout_rate
                                   is not None else dropout_rate,
                                   generator=generator)
        self.dropout2 = nn.Dropout(dropout_rate, generator=generator)
        self.norm = nn.LayerNorm(d_model, epsilon, device=device)
        self.activation = getattr(F, activation)

    def forward(self, src, cache=None):
        _no_cache(cache)
        residual = src
        if self.normalize_before:
            src = self.norm(src)
        src = self.linear2(self.dropout1(self.activation(self.linear1(src))))
        if not self.normalize_before:
            return _fused_epilogue(src, residual, self.norm,
                                   self.dropout2.p, self.training,
                                   self.generator)
        return residual + self.dropout2(src)


class FusedTransformerEncoderLayer(_nn.Module):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, *,
                 device=None, generator=None):
        super().__init__()
        kw = {"normalize_before": normalize_before, "device": device,
              "generator": generator}
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate,
            attn_dropout_rate if attn_dropout_rate is not None
            else dropout_rate, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate, **kw)

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedLinear(nn.Linear):
    pass
