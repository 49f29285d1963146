"""The weight bridge and ``Sequential`` of the PyTorch port.

``load_numpy_state_dict`` is the counterpart of ``Layer.set_state_dict``
(``paddle_tpu/nn/layer/layers.py:278``) for the port's
``torch.nn.Module``s: a reference state dict, ``{name: np.ndarray}``
built from a reference layer's ``state_dict()``, copied into a port
module whose names are the reference's. ``Sequential`` is the
counterpart of ``paddle_tpu/nn/layer/layers.py:371``: its children are
named ``"0"``, ``"1"``, ... in order, or by the keys of one
``OrderedDict``, or by the names of ``(name, layer)`` pairs.
"""
from __future__ import annotations

import collections

import torch

from ...core.dtype import numpy_to_torch


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
