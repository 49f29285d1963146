"""``TensorParallel`` and the full-tensor state dict of the PyTorch port's
sharded wrappers.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
tensor_parallel.py``. The wrapper runs the wrapped layer; its
``state_dict`` gives, and ``set_state_dict`` takes, the full logical
tensors under the reference's keys: each parameter split over a mesh axis
(its ``sharding_spec``) is gathered over that axis's group, or cut to this
rank's block. So a checkpoint of either package loads into the other.
A split over "model" is held as a block; ZeRO's "sharding" annotation
splits the update only, and every rank keeps the whole parameter.
"""
from __future__ import annotations

import torch

from ....nn.layer.layers import Layer
from ... import collective as C


def _axis_groups(hcg):
    if hcg is None:
        return {}
    return {"model": hcg.get_model_parallel_group()}


def _split_dims(tensor, groups):
    """(dim, group) for each dimension of ``tensor``'s ``sharding_spec``
    split over a group of several ranks."""
    spec = getattr(tensor, "sharding_spec", None) or ()
    return [(d, groups[a]) for d, a in enumerate(spec)
            if a in groups and groups[a].nranks > 1]


@torch.no_grad()
def full_state_dict(layer, hcg):
    """``layer.state_dict()`` with every split tensor gathered whole."""
    groups = _axis_groups(hcg)
    params = dict(layer.named_parameters())
    out = {}
    for k, v in layer.state_dict().items():
        t = params.get(k, v)
        for d, g in _split_dims(t, groups):
            v = torch.cat(C.all_gather([], v.contiguous(), g), dim=d)
        out[k] = v
    return out


@torch.no_grad()
def set_full_state_dict(layer, state, hcg):
    """Load full tensors: each split parameter takes this rank's block."""
    groups = _axis_groups(hcg)
    params = dict(layer.named_parameters())
    local = {}
    for k, v in state.items():
        v = torch.as_tensor(v)
        t = params.get(k)
        if t is not None:
            for d, g in _split_dims(t, groups):
                v = v.chunk(g.nranks, d)[g.rank]
        local[k] = v
    return layer.set_state_dict(local)


class TensorParallel(Layer):
    def __init__(self, layers: Layer, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, include_sublayers=True, recurse=None):
        return self._layers.parameters(include_sublayers, recurse)

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        return self._layers.named_parameters(prefix, include_sublayers,
                                             remove_duplicate, recurse)

    def state_dict(self, *a, **kw):
        return full_state_dict(self._layers, self._hcg)

    def set_state_dict(self, state_dict, *a, **kw):
        return set_full_state_dict(self._layers, state_dict, self._hcg)
