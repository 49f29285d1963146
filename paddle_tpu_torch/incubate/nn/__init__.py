"""Fused transformer layers of the PyTorch port.

Counterpart of ``paddle_tpu/incubate/nn/__init__.py`` (``_fused_epilogue``,
``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer``, ``FusedLinear``, ``:19-118``;
``FusedMultiTransformer``, ``:121-280``). "Fused" means what it
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
and ``ring_id`` (which the reference ignores) are not ported.

``cache`` is the reference's, behaviour for behaviour:
``FusedMultiHeadAttention`` hands it to its attention and keeps the
output only, so the updated cache is dropped (``:55-57``);
``FusedFeedForward`` takes it and never reads it; so
``FusedTransformerEncoderLayer`` returns its output alone.
"""
from __future__ import annotations

import math

import torch
from torch import nn as _nn

from ... import nn
from ...core.generator import torch_generator
from ...core.place import resolve_device
from ...nn import functional as F
from ...ops.dropout_ln import fused_dropout_add_layer_norm
from ...ops.linalg import matmul


def _fused_epilogue(x, residual, ln, p, training, generator=None):
    """LayerNorm ``ln`` of residual + dropout(x), through the fused
    kernel."""
    return fused_dropout_add_layer_norm(x, residual, ln.weight, ln.bias,
                                        p=p, eps=ln.epsilon,
                                        training=training,
                                        generator=generator)


class FusedMultiHeadAttention(nn.Layer):
    """Attention with its residual: pre-LN ``query + dropout(attn(
    ln_pre(query)))`` or post-LN ``ln_post(query + dropout(attn(query)))``
    (the fused epilogue). A ``cache`` reaches the attention; its update
    is dropped, as in the reference. The reference accepts ``kdim``,
    ``vdim``, ``need_weights``, the ``*_attr`` arguments, ``nranks`` and
    ``ring_id`` and reads none of them (its attention's projections take
    the default initializers); so does the port."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, *, device=None,
                 generator=None):
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
        residual = query
        if self.normalize_before:
            query = self.ln_pre(query)
        out = self.attn(query, key, value, attn_mask=attn_mask, cache=cache)
        if isinstance(out, tuple):
            out = out[0]
        if not self.normalize_before:
            return _fused_epilogue(out, residual, self.ln_post,
                                   self.dropout.p, self.training,
                                   self.generator)
        return residual + self.dropout(out)


class FusedFeedForward(nn.Layer):
    """linear2(dropout1(activation(linear1(x)))) with its residual, pre-LN
    or post-LN (the fused epilogue). ``linear1_*_attr`` /
    ``linear2_*_attr`` reach the two ``Linear``s; the ``ln*_attr``
    arguments, ``nranks`` and ``ring_id`` are accepted and never read, as
    in the reference."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None, *, device=None,
                 generator=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.generator = generator
        kw = {"device": device, "generator": generator}
        self.linear1 = nn.Linear(d_model, dim_feedforward,
                                 linear1_weight_attr, linear1_bias_attr, **kw)
        self.linear2 = nn.Linear(dim_feedforward, d_model,
                                 linear2_weight_attr, linear2_bias_attr, **kw)
        self.dropout1 = nn.Dropout(act_dropout_rate if act_dropout_rate
                                   is not None else dropout_rate,
                                   generator=generator)
        self.dropout2 = nn.Dropout(dropout_rate, generator=generator)
        self.norm = nn.LayerNorm(d_model, epsilon, device=device)
        self.activation = getattr(F, activation)

    def forward(self, src, cache=None):
        """``cache`` is accepted and never read, as in the reference."""
        residual = src
        if self.normalize_before:
            src = self.norm(src)
        src = self.linear2(self.dropout1(self.activation(self.linear1(src))))
        if not self.normalize_before:
            return _fused_epilogue(src, residual, self.norm,
                                   self.dropout2.p, self.training,
                                   self.generator)
        return residual + self.dropout2(src)


class FusedTransformerEncoderLayer(nn.Layer):
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
        return self.ffn(self.fused_attn(src, attn_mask=src_mask,
                                        cache=cache))


class FusedLinear(nn.Linear):
    pass


# the reference's table: jax.nn.gelu's default is the tanh approximation
_ACTIVATIONS = {"gelu": lambda x: F.gelu(x, approximate=True),
                "relu": F.relu}


def _write_step(cache, k, v, t_step):
    """A copy of one layer's (B, 2, H, max_len, hd) cache with this step's
    k and v (B, H, T, hd) written at ``t_step``: ``dynamic_update_slice``,
    whose start is clamped so that the T positions fit, and which refuses
    a dtype other than the cache's."""
    if k.dtype != cache.dtype:
        raise TypeError(f"the cache is {cache.dtype} and this step's K/V "
                        f"{k.dtype}: cast one to the other (the reference's "
                        "dynamic_update_slice requires arguments to have "
                        "the same dtypes)")
    T = k.shape[2]
    start = min(max(t_step, 0), cache.shape[3] - T)
    new = cache.clone()
    new[:, 0, :, start:start + T] = k
    new[:, 1, :, start:start + T] = v
    return new


class FusedMultiTransformer(nn.Layer):
    """The whole decoder stack as one module, the reference's
    (``paddle_tpu/incubate/nn/__init__.py:121-280``): per-layer weights
    stacked on a leading axis (``qkv_weight`` (L, D, 3D), ``qkv_bias``,
    ``out_weight``, ``out_bias``, ``ffn1_*``, ``ffn2_*``, ``ln_scale`` /
    ``ln_bias``, ``ffn_ln_scale`` / ``ffn_ln_bias``: the reference's names
    and shapes), walked by a Python loop (the reference's ``lax.scan``),
    and a functional (L, B, 2, H, max_len, hd) KV cache from
    ``gen_cache`` for incremental decoding. Weights start uniform in
    ±sqrt(6 / fan_in), biases and LayerNorm shifts at 0 and scales at 1,
    in float32 on ``device`` from ``generator``.

    The reference's arithmetic, kept: everything runs in x's dtype (and
    the weights', promoted as ``jnp`` does): LayerNorm is the plain
    formula ``(x - mu) / sqrt(var + eps) * scale + bias``; the scores are
    divided by sqrt(head_dim) in x's dtype; masked scores take
    ``finfo(x.dtype).min``; the softmax is not upcast; ``"gelu"`` is the
    tanh approximation (``jax.nn.gelu``'s default); ``dropout_rate``,
    ``nranks`` and ``ring_id`` are accepted and never read.

    And its masks: without ``caches``, ``attn_mask`` (added to the
    scores) replaces the top-left causal mask; with ``caches`` and a
    ``time_step``, this step's K/V are written at ``time_step`` and every
    key below ``time_step + T`` is attended, ``attn_mask`` ignored (so a
    step of T > 1 tokens is not causal; token-by-token decode is); with
    ``caches`` and no ``time_step``, the step attends over itself alone
    and the cache comes back unchanged. A cache whose dtype is not the
    step's raises TypeError (``gen_cache`` is float32: cast it for a
    bfloat16 stack)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, epsilon=1e-5, nranks=1, ring_id=-1,
                 name=None, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch_generator(generator, dev)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.num_layers = num_layers
        self.dim_feedforward = dim_feedforward
        self.epsilon = epsilon
        self.activation = activation
        self.normalize_before = normalize_before

        def init(shape, fan_in):
            limit = math.sqrt(6.0 / max(1, fan_in))
            w = torch.empty(shape, device=dev)
            return _nn.Parameter(w.uniform_(-limit, limit, generator=gen))

        def const(shape, value):
            return _nn.Parameter(torch.full(shape, value, device=dev))

        L, D, Fd = num_layers, embed_dim, dim_feedforward
        self.qkv_weight = init((L, D, 3 * D), D)
        self.qkv_bias = const((L, 3 * D), 0.0)
        self.out_weight = init((L, D, D), D)
        self.out_bias = const((L, D), 0.0)
        self.ffn1_weight = init((L, D, Fd), D)
        self.ffn1_bias = const((L, Fd), 0.0)
        self.ffn2_weight = init((L, Fd, D), Fd)
        self.ffn2_bias = const((L, D), 0.0)
        self.ln_scale = const((L, D), 1.0)
        self.ln_bias = const((L, D), 0.0)
        self.ffn_ln_scale = const((L, D), 1.0)
        self.ffn_ln_bias = const((L, D), 0.0)

    def gen_cache(self, batch_size, max_len):
        """An empty float32 KV cache (L, B, 2, H, max_len, hd)."""
        return torch.zeros((self.num_layers, batch_size, 2, self.num_heads,
                            max_len, self.head_dim),
                           device=self.qkv_weight.device)

    def _ln(self, x, scale, bias):
        mu = x.mean(-1, keepdim=True)
        var = torch.square(x - mu).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.epsilon) * scale + bias

    def _layer(self, i, h, mask, cache, t_step, act):
        """Layer ``i`` on h (B, T, D): (h, the layer's new cache)."""
        B, T, D = h.shape
        H, hd = self.num_heads, self.head_dim
        pre = self.normalize_before
        resid = h
        hin = self._ln(h, self.ln_scale[i], self.ln_bias[i]) if pre else h
        qkv = matmul(hin, self.qkv_weight[i]) + self.qkv_bias[i]
        q, k, v = (z.reshape(B, T, H, hd).transpose(1, 2)
                   for z in qkv.chunk(3, dim=-1))
        key_mask = None
        new_cache = cache
        if cache is not None and t_step is not None:
            new_cache = _write_step(cache, k, v, t_step)
            k, v = new_cache[:, 0], new_cache[:, 1]
            key_mask = torch.arange(k.shape[2], device=h.device) \
                < t_step + T
        scale = torch.sqrt(torch.tensor(float(hd), dtype=h.dtype,
                                        device=h.device))
        scores = matmul(q, k, transpose_y=True) / scale
        neg = torch.finfo(h.dtype).min
        if key_mask is not None:
            scores = scores.masked_fill(~key_mask, neg)
        elif mask is not None:
            scores = scores + mask
        else:
            causal = torch.ones((T, k.shape[2]), dtype=torch.bool,
                                device=h.device).tril()
            scores = scores.masked_fill(~causal, neg)
        attn = matmul(torch.softmax(scores, -1), v)
        attn = attn.transpose(1, 2).reshape(B, T, D)
        h = resid + matmul(attn, self.out_weight[i]) + self.out_bias[i]
        if not pre:
            h = self._ln(h, self.ln_scale[i], self.ln_bias[i])
        resid = h
        hin = self._ln(h, self.ffn_ln_scale[i], self.ffn_ln_bias[i]) \
            if pre else h
        h = resid + matmul(act(matmul(hin, self.ffn1_weight[i])
                               + self.ffn1_bias[i]),
                           self.ffn2_weight[i]) + self.ffn2_bias[i]
        if not pre:
            h = self._ln(h, self.ffn_ln_scale[i], self.ffn_ln_bias[i])
        return h, new_cache

    def forward(self, src, attn_mask=None, caches=None, time_step=None):
        """src (B, T, D) -> (B, T, D); with ``caches`` (L, B, 2, H,
        max_len, hd): (out, new caches)."""
        act = _ACTIVATIONS[self.activation]
        t_step = None if time_step is None else int(time_step)
        h, new_caches = src, []
        for i in range(self.num_layers):
            h, c = self._layer(i, h, attn_mask,
                               None if caches is None else caches[i],
                               t_step, act)
            new_caches.append(c)
        if caches is None:
            return h
        return h, torch.stack(new_caches)
