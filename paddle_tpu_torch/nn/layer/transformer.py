"""``MultiHeadAttention`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/layer/transformer.py:25-95``: q/k/v/out
projections (``Linear``, weights (in, out)) around
``F.scaled_dot_product_attention`` in the (batch, seq, heads, head_dim)
layout, so eligible shapes run the flash kernels. ``Cache``,
``StaticCache`` and ``gen_cache`` are not ported yet: they come with the
decoder layers (ROADMAP Queue 1); passing a ``cache`` raises.
"""
from __future__ import annotations

from torch import nn

from .. import functional as F
from .common import Linear


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
        if cache is not None:
            raise NotImplementedError(
                "MultiHeadAttention caches are not ported yet (ROADMAP "
                "Queue 1: the decoder layers)")
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
