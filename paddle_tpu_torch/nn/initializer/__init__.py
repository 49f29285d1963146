"""Initializers and ``ParamAttr`` of the PyTorch port.

Counterpart of ``paddle_tpu/nn/initializer/__init__.py``: the 12
initializers (``Constant``, ``Normal``, ``TruncatedNormal``, ``Uniform``,
``XavierNormal`` / ``XavierUniform``, ``KaimingNormal`` /
``KaimingUniform``, ``Orthogonal``, ``Assign``, ``Dirac``, ``Bilinear``),
``calculate_gain``, ``set_global_initializer`` / ``get_global_initializer``
and ``ParamAttr``, with the reference's formulas and fan rule
(``_fan_in_out``: a 3-d or larger shape is (out, in, *receptive field),
so fan_in = shape[1] * receptive and fan_out = shape[0] * receptive).

An initializer is called as ``init(shape, dtype=None, *, device=None,
generator=None)`` and returns a tensor on ``device`` (``cuda`` unless
``"cpu"`` is asked for; without a card the default raises), float32 when
``dtype`` is None. The random ones draw in float32 from ``generator``
(the default generator when None) and cast; the draws are torch's, not
JAX's, so the two packages agree in distribution only.

As in the reference, ``set_global_initializer`` stores the pair and no
layer reads it, and of a ``ParamAttr`` the layers read ``initializer``
and ``trainable`` (``nn.layer.layers.create_parameter``):
``learning_rate`` becomes the parameter's ``optimize_attr``, which no
optimizer reads, and ``regularizer`` and ``need_clip`` are stored only
(ROADMAP Queue 3).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.dtype import convert_dtype
from ...core.generator import torch_generator
from ...core.place import resolve_device


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    # conv weights are stored OIHW (matching the reference's layout)
    fan_in = shape[1] * receptive
    fan_out = shape[0] * receptive
    return fan_in, fan_out


def _dtype(dtype):
    return torch.float32 if dtype is None else convert_dtype(dtype)


def _shape(shape):
    return tuple(int(s) for s in shape)


class Initializer:
    def __call__(self, shape, dtype=None, *, device=None, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, *, device=None, generator=None):
        return torch.full(_shape(shape), self.value, dtype=_dtype(dtype),
                          device=resolve_device(device))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, *, device=None, generator=None):
        dev = resolve_device(device)
        z = torch.empty(_shape(shape), dtype=torch.float32, device=dev)
        z.normal_(self.mean, self.std,
                  generator=torch_generator(generator, dev))
        return z.to(_dtype(dtype))


class TruncatedNormal(Initializer):
    """N(mean, std) truncated at two standard deviations (the
    reference's ``jax.random.truncated_normal(-2, 2)``): a uniform draw
    between the normal CDF's values at -2 and 2, through the inverse
    CDF."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, *, device=None, generator=None):
        dev = resolve_device(device)
        lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2, 2))
        u = torch.empty(_shape(shape), dtype=torch.float32, device=dev)
        u.uniform_(2 * lo - 1, 2 * hi - 1,
                   generator=torch_generator(generator, dev))
        z = torch.clamp(math.sqrt(2) * torch.erfinv(u), -2.0, 2.0)
        return (z * self.std + self.mean).to(_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, *, device=None, generator=None):
        dev = resolve_device(device)
        z = torch.empty(_shape(shape), dtype=torch.float32, device=dev)
        z.uniform_(self.low, self.high,
                   generator=torch_generator(generator, dev))
        return z.to(_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype=None, **kw):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        return Normal(0.0, math.sqrt(2.0 / (fi + fo)))(shape, dtype, **kw)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype=None, **kw):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, **kw)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype=None, **kw):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype, **kw)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype=None, **kw):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, **kw)


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal columns (or rows, when it
    is wider than tall) over (prod(shape[:-1]), shape[-1]): the QR of a
    normal draw with R's diagonal signs folded in, as
    ``jax.nn.initializers.orthogonal``."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=None, *, device=None, generator=None):
        dev = resolve_device(device)
        shape = _shape(shape)
        n_cols = shape[-1]
        n_rows = math.prod(shape) // n_cols
        mshape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
        a = torch.empty(mshape, dtype=torch.float32, device=dev)
        a.normal_(generator=torch_generator(generator, dev))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return (self.gain * q.reshape(shape)).to(_dtype(dtype))


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, *, device=None, generator=None):
        v = self.value
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v))
        return v.to(device=resolve_device(device), dtype=_dtype(dtype)) \
            .reshape(_shape(shape)).clone()


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=None, *, device=None, generator=None):
        arr = np.zeros(_shape(shape), dtype=np.float32)
        o, i = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        for k in range(min(o, i * self.groups)):
            arr[(k, k % i) + tuple(centers)] = 1.0
        return torch.from_numpy(arr).to(device=resolve_device(device),
                                        dtype=_dtype(dtype))


# lowercase aliases used in ParamAttr(initializer=...)
constant = Constant
normal = Normal
uniform = Uniform


class ParamAttr:
    """~ paddle.ParamAttr: how a layer creates one parameter."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


class Bilinear(Initializer):
    """The bilinear-upsampling kernel of a transposed convolution's weight
    (C_out, C_in, k, k), the same in every channel pair."""

    def __call__(self, shape, dtype=None, *, device=None, generator=None):
        arr = np.zeros(_shape(shape), dtype=np.float32)
        if len(shape) >= 3:
            k = shape[-1]
            f = int(np.ceil(k / 2.0))
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            kernel1d = 1 - np.abs(np.arange(k) / f - c)
            arr[...] = (np.outer(kernel1d, kernel1d) if len(shape) >= 4
                        else kernel1d)
        return torch.from_numpy(arr).to(device=resolve_device(device),
                                        dtype=_dtype(dtype))


def calculate_gain(nonlinearity, param=None):
    """~ paddle.nn.initializer.calculate_gain."""
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0,
        "relu": float(np.sqrt(2.0)),
        "leaky_relu": float(np.sqrt(2.0 / (1 + (param if param is not None
                                                else 0.01) ** 2))),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return gains[nonlinearity]


_global_initializer = None


def set_global_initializer(weight_init, bias_init=None):
    """Stores (weight_init, bias_init); as in the reference, no layer
    reads it."""
    global _global_initializer
    _global_initializer = (weight_init, bias_init)


def get_global_initializer():
    return _global_initializer
