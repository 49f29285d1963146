"""``Layer``, its containers and the weight bridge of the PyTorch port.

Counterpart of ``paddle_tpu/nn/layer/layers.py:20-471``. ``Layer`` is a
``torch.nn.Module`` that adds Paddle's names; every layer of the port
derives from it. torch calls several of these names itself (the
``state_dict`` recursion with ``destination=`` / ``prefix=`` /
``keep_vars=``, ``register_buffer(..., persistent=)``, ``to(tensor)``,
``copy.deepcopy``), so each override takes torch's form as well as
Paddle's and leaves the recursion to torch. ``__call__`` is torch's: the
Paddle hooks are torch's forward pre-hooks and forward hooks, which run
in the reference's order (pre-hooks in registration order, each may
replace the inputs; then ``forward``; then the post-hooks, each may
replace the output: ``:254-265``).

Paddle's meaning, where the two differ: ``parameters()`` and
``buffers()`` return lists; ``named_sublayers`` / ``sublayers`` walk the
tree in pre-order without removing repeats, ``include_self`` first;
``state_dict()`` lists every parameter before every persistable buffer
(the reference's order; torch's lists each module's buffers after its
own parameters), its values the live tensors detached (torch's); the
``set_state_dict`` / ``load_dict`` copy returns ``(missing,
unexpected)`` and raises only on a shape mismatch (``:278-298``);
``create_parameter`` makes a parameter on the default device
(``core.place``: ``cuda`` unless ``set_device`` said otherwise) from the
default generator; ``to(device, dtype, blocking)`` takes Paddle's names
("gpu", "bfloat16", places). Every other ``torch.nn.Module`` method keeps
torch's meaning (``train(mode)``, ``apply``, ``zero_grad``,
``load_state_dict``, ``__repr__``).

``load_numpy_state_dict`` copies a reference state dict, ``{name:
np.ndarray}``, into a port module whose names are the reference's.
"""
from __future__ import annotations

import collections
import itertools

import torch

from ...core import place as _place
from ...core.dtype import convert_dtype, numpy_to_torch


def create_parameter(shape, attr=None, is_bias=False,
                     default_initializer=None, *, dtype=None, device=None,
                     generator=None) -> torch.nn.Parameter:
    """A parameter of ``shape`` (``dtype``, float32 when None) made by
    ``attr.initializer`` when a ``ParamAttr`` gives one, else by
    ``default_initializer``, else by ``Constant(0)`` for a bias and
    ``XavierNormal`` otherwise, on ``device``, random draws from
    ``generator``. ``attr.trainable=False`` leaves it without gradient;
    ``attr.learning_rate`` is kept as ``p.optimize_attr`` (which no
    optimizer reads, as in the reference)."""
    from .. import initializer as init
    if default_initializer is None:
        default_initializer = (init.Constant(0.0) if is_bias
                               else init.XavierNormal())
    if attr is not None and getattr(attr, "initializer", None) is not None:
        default_initializer = attr.initializer
    p = torch.nn.Parameter(default_initializer(shape, dtype, device=device,
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


class HookRemoveHelper:
    """The handle a Paddle hook registration returns: ``remove()`` takes
    the hook out (torch's ``RemovableHandle`` underneath)."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self):
        self._handle.remove()


_scope_counts: dict = collections.defaultdict(itertools.count)


def _to_args(args, kwargs):
    """Paddle's ``to(device, dtype, blocking)`` (names, places, dtype
    strings) or torch's forms -> torch's keyword arguments, or the torch
    positional arguments unchanged (``to(tensor)``, ``memory_format``)."""
    if any(isinstance(a, torch.Tensor) for a in args) \
            or "memory_format" in kwargs or "tensor" in kwargs:
        return args, kwargs
    device, dtype = kwargs.pop("device", None), kwargs.pop("dtype", None)
    blocking = kwargs.pop("blocking", None)
    for a in args:
        if isinstance(a, bool):
            blocking = a
        elif isinstance(a, torch.dtype) or (isinstance(a, str)
                                            and _is_dtype(a)):
            dtype = a
        elif a is not None:
            device = a
    out = dict(kwargs)
    if device is not None:
        out["device"] = _place.resolve_device(device)
    if dtype is not None:
        out["dtype"] = convert_dtype(dtype)
    if blocking is not None:
        out["non_blocking"] = not blocking
    return (), out


def _is_dtype(name):
    try:
        convert_dtype(name)
    except TypeError:
        return False
    return True


class Layer(torch.nn.Module):
    """The base of every layer (``paddle.nn.Layer``): a
    ``torch.nn.Module`` with Paddle's names (module docstring)."""

    def __init__(self, name_scope: str | None = None, dtype="float32"):
        super().__init__()
        self._dtype = convert_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()
        self._full_name = (f"{self._name_scope}_"
                           f"{next(_scope_counts[self._name_scope])}")

    # ---- registration ----------------------------------------------------
    def add_parameter(self, name: str, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    torch.nn.Parameter):
            parameter = torch.nn.Parameter(parameter)
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent: bool | None = None):
        """Paddle's ``persistable`` or torch's ``persistent``: whether the
        buffer is in ``state_dict``. Returns ``tensor``."""
        super().register_buffer(name, tensor, persistent=persistable
                                if persistent is None else persistent)
        return tensor

    def create_parameter(self, shape, dtype=None, attr=None, is_bias=False,
                         default_initializer=None):
        """A parameter made as the module function ``create_parameter``
        makes it, of ``dtype`` (the layer's, float32 by default), on the
        default device, drawing from the default generator. Not
        registered: assign it to an attribute."""
        return create_parameter(shape, attr, is_bias, default_initializer,
                                dtype=dtype or self._dtype)

    # ---- iteration -------------------------------------------------------
    def parameters(self, include_sublayers: bool = True, recurse=None):
        return list(super().parameters(
            include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         remove_duplicate: bool = True, recurse=None):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers: bool = True, recurse=None):
        return list(super().buffers(
            include_sublayers if recurse is None else recurse))

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        if include_self:
            yield prefix, self
        for name, layer in self._modules.items():
            if layer is None:
                continue
            sub = f"{prefix}.{name}" if prefix else name
            yield sub, layer
            if isinstance(layer, Layer):
                yield from layer.named_sublayers(sub)
            else:
                for n, m in layer.named_modules(prefix=sub):
                    if m is not layer:
                        yield n, m

    def sublayers(self, include_self: bool = False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    # ---- device / dtype --------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's ``to`` under Paddle's names too: ``to("gpu")``,
        ``to(dtype="bfloat16")``, ``to(place, dtype, blocking)``; a
        floating dtype becomes every sublayer's ``_dtype``."""
        args, kwargs = _to_args(args, kwargs)
        out = super().to(*args, **kwargs)
        dtype = kwargs.get("dtype")
        if dtype is not None and dtype.is_floating_point:
            for layer in self.sublayers(include_self=True):
                if isinstance(layer, Layer):
                    layer._dtype = dtype
        return out

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype=torch.float32)

    def bfloat16(self):
        return self.to(dtype=torch.bfloat16)

    # ---- hooks -----------------------------------------------------------
    def register_forward_pre_hook(self, hook, **kwargs) -> HookRemoveHelper:
        """``hook(layer, inputs)``, before ``forward``; a return value that
        is not None replaces the inputs (a tuple, or one input)."""
        return HookRemoveHelper(super().register_forward_pre_hook(hook,
                                                                   **kwargs))

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, output)``, after ``forward``; a return
        value that is not None replaces the output."""
        return HookRemoveHelper(self.register_forward_hook(hook))

    # ---- state dict ------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True,
                   *, prefix: str = "", keep_vars: bool = False):
        """{name: tensor} of the parameters, then the persistable buffers
        (the reference's order). torch's recursion (a ``destination``
        given) is torch's own."""
        if destination is not None:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        if structured_name_prefix:
            prefix = structured_name_prefix.rstrip(".") + "."
        if include_sublayers:
            sd = super().state_dict(prefix=prefix, keep_vars=keep_vars)
        else:
            sd = collections.OrderedDict()
            sd._metadata = collections.OrderedDict()
            self._save_to_state_dict(sd, prefix, keep_vars)
        params = {prefix + n for n, _ in super().named_parameters(
            recurse=include_sublayers, remove_duplicate=False)}
        out = collections.OrderedDict(
            [(k, v) for k, v in sd.items() if k in params]
            + [(k, v) for k, v in sd.items() if k not in params])
        out._metadata = sd._metadata
        return out

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy the entries of ``state_dict`` (tensors or arrays) whose
        names this layer has into its parameters and buffers, cast to
        their dtypes. Returns (missing, unexpected) name lists; raises
        ValueError on a shape mismatch."""
        own = self.state_dict(keep_vars=True)
        missing = []
        with torch.no_grad():
            for name, t in own.items():
                if name not in state_dict:
                    missing.append(name)
                    continue
                v = state_dict[name]
                v = v if isinstance(v, torch.Tensor) else numpy_to_torch(v)
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f"shape mismatch for {name}: checkpoint "
                                     f"{tuple(v.shape)} vs layer "
                                     f"{tuple(t.shape)}")
                t.copy_(v.to(device=t.device, dtype=t.dtype))
        unexpected = [name for name in state_dict if name not in own]
        return missing, unexpected

    load_dict = set_state_dict

    def tree_flatten_params(self):
        """{name: tensor} of the parameters and persistable buffers, in
        ``state_dict``'s order: the counterpart of the reference's pytree
        for its compiled steps. Pairs with ``load_tree``."""
        return dict(self.state_dict())

    def load_tree(self, tree) -> None:
        """Copy the entries of ``tree`` whose names this layer has."""
        own = self.state_dict(keep_vars=True)
        with torch.no_grad():
            for name, v in tree.items():
                if name in own:
                    own[name].copy_(v)

    def full_name(self) -> str:
        """The layer's unique name: its name scope and a counter."""
        return self._full_name


class LayerList(Layer):
    """Sublayers named "0", "1", ... in order (``paddle.nn.LayerList``)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return type(self)(list(self._modules.values())[idx])
        if idx < 0:
            idx += len(self)
        return self._modules[str(idx)]

    def __setitem__(self, idx, layer):
        # the reference keys the layer by str(idx) as given: a negative
        # index adds a sublayer named "-1" (README, the reference's traps)
        self._modules[str(idx)] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, l in enumerate(layers):
            self.add_sublayer(str(i), l)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class Sequential(Layer):
    """Calls its sublayers in order; they are named "0", "1", ..., or by
    the keys of one ``OrderedDict``, or by ``(name, layer)`` pairs.
    Indexing gives a sublayer, or a list of them for a slice (the
    reference's)."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
            return
        for i, layer in enumerate(layers):
            if isinstance(layer, (tuple, list)) and len(layer) == 2:
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class ParameterList(Layer):
    """Parameters named "0", "1", ... (``paddle.nn.ParameterList``);
    indexed by their names, so a negative index raises KeyError, as in
    the reference."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self


class LayerDict(Layer):
    """Sublayers by name, in insertion order (``paddle.nn.LayerDict``)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, sublayer):
        self.add_sublayer(key, sublayer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        if isinstance(sublayers, dict):
            sublayers = sublayers.items()
        for k, v in sublayers:
            self.add_sublayer(k, v)
