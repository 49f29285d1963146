"""``MultiHeadAttention``, the encoder and decoder layers and stacks, and
``Transformer`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/layer/transformer.py:25-314``.
``MultiHeadAttention``: q/k/v/out projections (``Linear``, weights (in,
out)) around ``F.scaled_dot_product_attention`` in the (batch, seq,
heads, head_dim) layout, so eligible shapes run the flash kernels. Its
caches are the reference's namedtuples: a ``StaticCache`` holds the
projected K/V of a fixed key (the decoder's memory) and replaces the
projections; a ``Cache`` is concatenated with this call's K/V, and the
result is returned as the new cache. A ``Cache`` step attends to all of
cache + step unless an ``attn_mask`` says otherwise (the reference's
behaviour: a step of several tokens is not causal by itself). An empty
``Cache`` from ``gen_cache`` is float32, as the reference's ``zeros``,
so in a bfloat16 layer its concatenation promotes K/V, the output and
the cache to float32, as ``jnp.concatenate`` does.

``TransformerEncoderLayer`` / ``TransformerDecoderLayer``: attention
(self, then cross for the decoder) and a feed-forward block, each with
its residual, LayerNorm (eps 1e-5) after it (post-LN) or before it
(``normalize_before``), as plain compositions (``incubate.nn`` holds the
fused ones). A decoder layer's cache is the pair (incremental ``Cache``
of its self-attention, ``StaticCache`` of its cross-attention).
``TransformerEncoder`` / ``TransformerDecoder``: the reference's stacks,
whose layers 1..L-1 are ``copy.deepcopy`` of the layer given, so every
layer starts from the same weights (the reference's behaviour, kept);
the copies draw their dropout from the generator of the layer given, not
from copies of it. ``Transformer``: an encoder and a decoder stack (or
``custom_encoder`` / ``custom_decoder``), with final norms only under
``normalize_before``. ``weight_attr`` / ``bias_attr`` (a ``ParamAttr``,
or False for no bias) reach every ``Linear`` of a layer, as in the
reference (``:31-47``, ``:101-113``); ``activation`` names a function of
the port's ``F``.
"""
from __future__ import annotations

import collections
import copy

import torch

from ...core.place import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .layers import Layer, LayerList
from .norm import LayerNorm


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
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
        attrs = (weight_attr, bias_attr)
        self.q_proj = Linear(embed_dim, embed_dim, *attrs, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, *attrs, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, *attrs, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, *attrs, **kw)

    def _heads(self, x, B):
        return x.reshape(B, -1, self.num_heads, self.head_dim)

    def _prepare_qkv(self, query, key, value, cache=None):
        """(q, k, v, cache): a ``StaticCache`` gives k and v; a ``Cache``
        is extended by this call's k and v and returned so."""
        B = query.shape[0]
        q = self._heads(self.q_proj(query), B)
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key), B)
            v = self._heads(self.v_proj(value), B)
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=None):
        """``type=StaticCache``, or neither ``value`` nor ``type``: the
        projected K/V of ``key`` (B, Sk, H, hd). ``type=Cache`` without
        ``value``: an empty float32 (B, 0, H, hd) cache, ``key`` a tensor
        or the batch size. ``value`` given: ``Cache(key, value)``."""
        if type == self.StaticCache or (value is None and type is None):
            B = key.shape[0]
            return self.StaticCache(self._heads(self.k_proj(key), B),
                                    self._heads(self.v_proj(key), B))
        if value is None:
            B = key.shape[0] if isinstance(key, torch.Tensor) else key
            shape = (B, 0, self.num_heads, self.head_dim)
            dev = self.q_proj.weight.device
            return self.Cache(torch.zeros(shape, device=dev),
                              torch.zeros(shape, device=dev))
        return self.Cache(key, value)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """query (B, Sq, E), key/value (B, Sk, kdim/vdim) -> (B, Sq, E),
        with ``None`` appended when ``need_weights`` and the (new) cache
        when one is given, in the reference's order."""
        key = query if key is None else key
        value = query if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        B, S = out.shape[0], out.shape[1]
        outs = [self.out_proj(out.reshape(B, S, self.embed_dim))]
        if self.need_weights:
            outs.append(None)
        if cache is not None:
            outs.append(cache)
        return outs[0] if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(Layer):
    """Self-attention then a feed-forward block (``linear2(dropout(
    activation(linear1(x))))``), each added to its residual through
    ``dropout1`` / ``dropout2``; post-LN (``norm1`` / ``norm2`` after each
    sum) or pre-LN (before each block). ``attn_dropout`` and
    ``act_dropout`` default to ``dropout``; ``activation`` names a
    function of the port's ``F`` (``relu``, ``gelu``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = {"device": device, "generator": generator}
        attrs = {"weight_attr": weight_attr, "bias_attr": bias_attr}
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **attrs, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, **attrs, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        """src (B, S, d_model); ``src_mask`` as
        ``F.scaled_dot_product_attention``'s ``attn_mask``. With a
        ``cache`` (a self-attention ``Cache``): (out, new cache)."""
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src, type=MultiHeadAttention.Cache)


def _stack(layer, num_layers):
    """``layer`` then ``num_layers - 1`` deep copies of it, the copies
    sharing the generators its dropouts draw from."""
    shared = {id(m.generator): m.generator for m in layer.modules()
              if isinstance(m, Dropout) and m.generator is not None}
    return LayerList([layer] + [copy.deepcopy(layer, dict(shared))
                                    for _ in range(num_layers - 1)])


class TransformerEncoder(Layer):
    """``num_layers`` layers (``layers``: the layer given, then deep
    copies of it), then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _stack(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        """With ``cache`` (one per layer): (out, new caches)."""
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over ``memory`` and a feed-forward
    block, each added to its residual through ``dropout1`` / ``dropout2``
    / ``dropout3``; post-LN (``norm1..3`` after each sum) or pre-LN
    (before each block)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = {"device": device, "generator": generator}
        attrs = {"weight_attr": weight_attr, "bias_attr": bias_attr}
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **attrs, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **attrs, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, **attrs, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """tgt (B, St, d_model), memory (B, Sm, d_model). With ``cache``
        (incremental, static): (out, (new incremental, static))."""
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                              cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static = self.cross_attn(tgt, memory, memory, memory_mask,
                                          cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental, static))

    def gen_cache(self, memory):
        """(an empty float32 ``Cache`` for the self-attention, the
        cross-attention's ``StaticCache`` of ``memory``)."""
        return (self.self_attn.gen_cache(memory,
                                         type=MultiHeadAttention.Cache),
                self.cross_attn.gen_cache(
                    memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(Layer):
    """``num_layers`` decoder layers (the layer given, then deep copies
    of it), then ``norm`` if given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _stack(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """With ``cache`` (one pair per layer): (out, new caches)."""
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask,
                                  cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """One (incremental, static) pair per layer; ``do_zip``: the
        pairs zipped into (incrementals, statics)."""
        caches = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*caches)) if do_zip else caches


class Transformer(Layer):
    """An encoder stack over ``src`` and a decoder stack over ``tgt`` and
    the encoder's output. The defaults are Transformer-base (d_model
    512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1, ReLU)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 generator=None):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        kw = {"device": device, "generator": generator}
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = LayerNorm(d_model, device=device) if normalize_before \
                else None
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = LayerNorm(d_model, device=device) if normalize_before \
                else None
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, *, device=None):
        """float32 (length, length): 0 on and below the diagonal, -inf
        above it."""
        dev = resolve_device(device)
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=dev).tril()
        return torch.zeros((length, length), device=dev).masked_fill(
            ~keep, float("-inf"))
