"""The weight bridge and ``Sequential`` of the PyTorch port.

``load_numpy_state_dict`` is the counterpart of ``Layer.set_state_dict``
(``paddle_tpu/nn/layer/layers.py:278``) for the port's
``torch.nn.Module``s: a reference state dict, ``{name: np.ndarray}``
built from a reference layer's ``state_dict()``, copied into a port
module whose names are the reference's. ``Sequential`` is the
counterpart of ``paddle_tpu/nn/layer/layers.py:371``: its children are
named ``"0"``, ``"1"``, ... in order, or by the keys of one
``OrderedDict``, or by the names of ``(name, layer)`` pairs.
``create_parameter`` is the counterpart of ``Layer.create_parameter``
(``paddle_tpu/nn/layer/layers.py:123-139``), which the port's layers
make their parameters with.
"""
from __future__ import annotations

import collections

import torch

from ...core.dtype import numpy_to_torch


def create_parameter(shape, attr=None, is_bias=False,
                     default_initializer=None, *, device=None,
                     generator=None) -> torch.nn.Parameter:
    """A float32 parameter of ``shape`` made by ``attr.initializer`` when
    a ``ParamAttr`` gives one, else by ``default_initializer``, else by
    ``Constant(0)`` for a bias and ``XavierNormal`` otherwise, on
    ``device``, random draws from ``generator``. ``attr.trainable=False`` leaves it without gradient;
    ``attr.learning_rate`` is kept as ``p.optimize_attr`` (which no
    optimizer reads, as in the reference)."""
    from .. import initializer as init
    if default_initializer is None:
        default_initializer = (init.Constant(0.0) if is_bias
                               else init.XavierNormal())
    if attr is not None and getattr(attr, "initializer", None) is not None:
        default_initializer = attr.initializer
    p = torch.nn.Parameter(default_initializer(shape, device=device,
                                               generator=generator))
    if attr is not None:
        if getattr(attr, "learning_rate", None) is not None:
            p.optimize_attr = {"learning_rate": attr.learning_rate}
        if getattr(attr, "trainable", True) is False:
            p.requires_grad_(False)
    return p


def load_numpy_state_dict(module: torch.nn.Module, state: dict):
    """Copy ``state`` ({name: np.ndarray}) into ``module``'s parameters
    and buffers, in place, key for key and without transposing anything
    (both packages keep projections as (in, out)). bfloat16 arrays are
    taken bit-exactly; each value is cast to its target's dtype. Raises
    KeyError on a missing or unexpected key and ValueError on a shape
    mismatch. Returns ``module``."""
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:4]}, "
                       f"unexpected {extra[:4]}")
    with torch.no_grad():
        for name, t in own.items():
            src = numpy_to_torch(state[name])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(device=t.device, dtype=t.dtype))
    return module


class Sequential(torch.nn.Sequential):
    """Calls its children in order."""

    def __init__(self, *layers):
        torch.nn.Module.__init__(self)
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_module(name, layer)
            return
        for i, layer in enumerate(layers):
            if isinstance(layer, (tuple, list)) and len(layer) == 2:
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)
