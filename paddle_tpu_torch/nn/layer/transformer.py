"""``MultiHeadAttention``, ``TransformerEncoderLayer`` and
``TransformerEncoder`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/layer/transformer.py:25-169``.
``MultiHeadAttention``: q/k/v/out projections (``Linear``, weights (in,
out)) around ``F.scaled_dot_product_attention`` in the (batch, seq,
heads, head_dim) layout, so eligible shapes run the flash kernels.
``TransformerEncoderLayer``: attention and a feed-forward block, each
with its residual, LayerNorm (eps 1e-5) after it (post-LN) or before it
(``normalize_before``), as plain compositions (``incubate.nn`` holds the
fused ones). ``TransformerEncoder``: the reference's stack, whose layers
1..L-1 are ``copy.deepcopy`` of the layer given, so every layer starts
from the same weights (the reference's behaviour, kept); the copies draw
their dropout from the generator of the layer given, not from copies of
it. ``Cache``, ``StaticCache`` and ``gen_cache`` are not ported yet: they
come with the decoder layers (ROADMAP Queue 1 item 7); passing a
``cache`` raises. The ``*_attr`` arguments are not ported.
"""
from __future__ import annotations

import copy

from torch import nn

from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm


def _no_cache(cache):
    if cache is not None:
        raise NotImplementedError(
            "transformer caches are not ported yet (ROADMAP Queue 1 item 7: "
            "the decoder layers)")


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, *, device=None,
                 generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        kw = {"device": device, "generator": generator}
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """query (B, Sq, E), key/value (B, Sk, kdim/vdim) -> (B, Sq, E),
        with ``None`` appended when ``need_weights`` (as the
        reference)."""
        _no_cache(cache)
        key = query if key is None else key
        value = query if value is None else value
        B, S = query.shape[0], query.shape[1]
        heads = (self.num_heads, self.head_dim)
        q = self.q_proj(query).reshape(B, S, *heads)
        k = self.k_proj(key).reshape(B, -1, *heads)
        v = self.v_proj(value).reshape(B, -1, *heads)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(out.reshape(B, S, self.embed_dim))
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(nn.Module):
    """Self-attention then a feed-forward block (``linear2(dropout(
    activation(linear1(x))))``), each added to its residual through
    ``dropout1`` / ``dropout2``; post-LN (``norm1`` / ``norm2`` after each
    sum) or pre-LN (before each block). ``attn_dropout`` and
    ``act_dropout`` default to ``dropout``; ``activation`` names a
    function of the port's ``F`` (``relu``, ``gelu``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = {"device": device, "generator": generator}
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        """src (B, S, d_model); ``src_mask`` as
        ``F.scaled_dot_product_attention``'s ``attn_mask``."""
        _no_cache(cache)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` layers (``layers``: the layer given, then deep
    copies of it), then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        # the copies share the generators they draw dropout from
        shared = {id(m.generator): m.generator
                  for m in encoder_layer.modules()
                  if isinstance(m, Dropout) and m.generator is not None}
        self.layers = nn.ModuleList([encoder_layer] + [
            copy.deepcopy(encoder_layer, dict(shared))
            for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        output = src
        for layer in self.layers:
            output = layer(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output
