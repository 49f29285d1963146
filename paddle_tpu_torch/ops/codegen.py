"""The op spec table of the PyTorch port, and the ops made from it.

Counterpart of ``paddle_tpu/ops/codegen.py`` and ``ops/specs.yaml``: the
reference keeps a YAML table of ``jnp`` lowerings (``op``, ``lowering``,
``args``, ``attrs``, ``nondiff``, ``group``) and makes each entry a
registered op at import (``generate``). Here the table is ``SPECS``, in
this module, with a torch lowering per entry (PyYAML is not among the
packages the port may assume). ``generate`` makes each entry an op of the
dispatch under its name, taking its tensor arguments and then its
attributes, positionally or by keyword, as the reference's do; the math
group is generated into ``ops.math``, the activation group into
``ops.activation``, and the 16 entries of the reference's default group
into ``ops`` itself. ``infer_meta`` runs an entry's lowering on tensors
of the ``meta`` device: the shape and dtype of its outputs, nothing
computed.

A binary entry's Python operand is made a tensor on the other's device
(``_util.as_tensor``: an int is int32, a float float32), which torch then
promotes as ``jnp`` promotes a weak type.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._util import narrow, pair
from .dispatch import OP_REGISTRY, apply_op


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _unwrap(x, axis=-1):
    """``jnp.unwrap`` (period 2 pi, discontinuity pi)."""
    dd = torch.diff(x, dim=axis)
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0),
                        torch.full_like(ddmod, math.pi), ddmod)
    corr = torch.where(dd.abs() < math.pi, torch.zeros_like(dd),
                       ddmod - dd)
    first = x.narrow(axis, 0, 1)
    return torch.cat([first, x.narrow(axis, 1, x.shape[axis] - 1)
                      + torch.cumsum(corr, dim=axis)], dim=axis)


def _renorm(x, p=2.0, axis=0, max_norm=1.0):
    red = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(x) ** p, dim=red, keepdim=True) ** (1.0 / p)
    return x * torch.clamp(max_norm / torch.clamp(norms, min=1e-7),
                           max=1.0)


def _softplus(x, beta=1.0, threshold=20.0):
    return torch.where(beta * x > threshold, x,
                       F.softplus(beta * x) / beta)


def _spec(op, lowering, args=("x",), attrs=None, group="misc",
          nondiff=False):
    return {"op": op, "lowering": lowering, "args": tuple(args),
            "attrs": dict(attrs or {}), "group": group, "nondiff": nondiff}


_XY = ("x", "y")

SPECS = [
    # the reference's default group (specs.yaml:19-98)
    _spec("logaddexp2", torch.logaddexp2, _XY),
    _spec("rot90_k2", lambda x: torch.rot90(x, 2, (0, 1))),
    _spec("sinc", torch.sinc),
    _spec("i0", torch.special.i0),
    _spec("i1", torch.special.i1),
    _spec("polygamma", lambda x, n=1: torch.polygamma(int(n), x),
          attrs={"n": 1}),
    _spec("xlogy", torch.xlogy, _XY),
    _spec("ldexp", lambda x, y: torch.ldexp(
        x, y.to(torch.int32).to(x.dtype)), _XY),
    _spec("vander", lambda x, n=3: x[..., None] ** torch.arange(
        n - 1, -1, -1, device=x.device), attrs={"n": 3}),
    _spec("trapezoid",
          lambda y, dx=1.0, axis=-1: torch.trapezoid(y, dx=dx, dim=axis),
          ("y",), {"dx": 1.0, "axis": -1}),
    _spec("unwrap", _unwrap, attrs={"axis": -1}),
    _spec("diff", lambda x, n=1, axis=-1: torch.diff(x, n=n, dim=axis),
          attrs={"n": 1, "axis": -1}),
    _spec("cummax", lambda x, axis=-1: torch.cummax(x, axis).values,
          attrs={"axis": -1}),
    _spec("cummin", lambda x, axis=-1: torch.cummin(x, axis).values,
          attrs={"axis": -1}),
    _spec("renorm", _renorm, attrs={"p": 2.0, "axis": 0, "max_norm": 1.0}),
    _spec("frexp", lambda x: tuple(torch.frexp(x)), nondiff=True),
]

# the elementwise binary family (group math)
SPECS += [_spec(name, fn, _XY, group="math") for name, fn in (
    ("add", torch.add), ("subtract", torch.subtract),
    ("multiply", torch.multiply), ("divide", torch.divide),
    ("floor_divide", torch.floor_divide), ("mod", torch.remainder),
    ("pow", torch.pow), ("maximum", torch.maximum),
    ("minimum", torch.minimum), ("fmax", torch.fmax), ("fmin", torch.fmin),
    ("atan2", torch.atan2), ("hypot", torch.hypot),
    ("logaddexp", torch.logaddexp), ("nextafter", torch.nextafter),
    ("copysign", torch.copysign), ("heaviside", torch.heaviside),
    ("gcd", torch.gcd), ("lcm", torch.lcm))]

# the elementwise unary family (group math)
SPECS += [_spec(name, fn, group="math") for name, fn in (
    ("exp", torch.exp), ("expm1", torch.expm1), ("log", torch.log),
    ("log2", torch.log2), ("log10", torch.log10), ("log1p", torch.log1p),
    ("sqrt", torch.sqrt), ("rsqrt", torch.rsqrt), ("square", torch.square),
    ("abs", torch.abs), ("sign", torch.sign), ("neg", torch.neg),
    ("reciprocal", torch.reciprocal), ("floor", torch.floor),
    ("ceil", torch.ceil), ("round", torch.round), ("trunc", torch.trunc),
    ("frac", lambda x: x - torch.trunc(x)), ("sin", torch.sin),
    ("cos", torch.cos), ("tan", torch.tan), ("asin", torch.asin),
    ("acos", torch.acos), ("atan", torch.atan), ("sinh", torch.sinh),
    ("cosh", torch.cosh), ("tanh", torch.tanh), ("asinh", torch.asinh),
    ("acosh", torch.acosh), ("atanh", torch.atanh), ("erf", torch.erf),
    ("erfinv", torch.erfinv), ("lgamma", torch.lgamma),
    ("digamma", torch.digamma), ("deg2rad", torch.deg2rad),
    ("rad2deg", torch.rad2deg), ("angle", torch.angle),
    ("conj", lambda x: torch.conj(x).resolve_conj()), ("real", torch.real),
    ("imag", _imag))]

# the activation family (group activation)
SPECS += [_spec(*s, group="activation") for s in (
    ("relu", torch.relu),
    ("relu6", lambda x: torch.clamp(x, 0.0, 6.0)),
    ("leaky_relu",
     lambda x, negative_slope=0.01: F.leaky_relu(x, negative_slope),
     ("x",), {"negative_slope": 0.01}),
    ("prelu", lambda x, weight: torch.where(x >= 0, x, weight * x),
     ("x", "weight")),
    ("elu", lambda x, alpha=1.0: F.elu(x, alpha), ("x",), {"alpha": 1.0}),
    ("selu", lambda x, scale=1.0507009873554805,
     alpha=1.6732632423543772: scale * torch.where(
         x > 0, x, alpha * torch.expm1(x)),
     ("x",), {"scale": 1.0507009873554805, "alpha": 1.6732632423543772}),
    ("celu", lambda x, alpha=1.0: F.celu(x, alpha), ("x",),
     {"alpha": 1.0}),
    ("gelu", lambda x, approximate=False: F.gelu(
        x, approximate="tanh" if approximate else "none"), ("x",),
     {"approximate": False}),
    ("sigmoid", torch.sigmoid),
    ("hardsigmoid", lambda x, slope=0.16666666666666666, offset=0.5:
     torch.clamp(slope * x + offset, 0.0, 1.0), ("x",),
     {"slope": 0.16666666666666666, "offset": 0.5}),
    ("hardswish", lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)),
    ("hardtanh", lambda x, min=-1.0, max=1.0: torch.clamp(x, min, max),
     ("x",), {"min": -1.0, "max": 1.0}),
    ("hardshrink", lambda x, threshold=0.5: torch.where(
        torch.abs(x) > threshold, x, torch.zeros_like(x)), ("x",),
     {"threshold": 0.5}),
    ("softshrink", lambda x, threshold=0.5: torch.where(
        x > threshold, x - threshold, torch.where(
            x < -threshold, x + threshold, torch.zeros_like(x))), ("x",),
     {"threshold": 0.5}),
    ("tanhshrink", lambda x: x - torch.tanh(x)),
    ("silu", F.silu),
    ("mish", lambda x: x * torch.tanh(F.softplus(x))),
    ("softplus", _softplus, ("x",), {"beta": 1.0, "threshold": 20.0}),
    ("softsign", F.softsign),
    ("thresholded_relu", lambda x, threshold=1.0: torch.where(
        x > threshold, x, torch.zeros_like(x)), ("x",),
     {"threshold": 1.0}),
    ("log_sigmoid", F.logsigmoid),
    ("softmax", lambda x, axis=-1: torch.softmax(x, int(axis)), ("x",),
     {"axis": -1}),
    ("log_softmax", lambda x, axis=-1: torch.log_softmax(x, int(axis)),
     ("x",), {"axis": -1}))]


def _make_api(spec):
    opname, fn, nondiff = spec["op"], spec["lowering"], spec["nondiff"]
    attrs, n_args = spec["attrs"], len(spec["args"])
    attr_names = list(attrs)

    def raw(*args, **kwargs):
        return narrow(fn(*args, **kwargs), args)

    def api(*args, **kwargs):
        if len(args) > n_args + len(attr_names):
            raise TypeError(
                f"{opname}() takes at most {n_args + len(attr_names)} "
                f"positional argument(s) but {len(args)} were given")
        merged = dict(attrs)
        # attributes may follow the tensor arguments positionally, as in
        # the reference's signatures (leaky_relu(x, 0.1))
        for name, val in zip(attr_names, args[n_args:]):
            if name in kwargs:
                raise TypeError(f"{opname}() got multiple values for "
                                f"argument '{name}'")
            merged[name] = val
        merged.update(kwargs)
        tensors = list(args[:n_args])
        if n_args == 2:
            tensors = pair(*tensors)
        return apply_op(opname, raw, *tensors, nondiff=nondiff, **merged)

    api.__name__ = api.__qualname__ = opname
    api.op_name = opname
    api.raw_fn = raw
    return api


def generate(namespace: dict, groups=None, exclude_groups=None) -> list:
    """Make an op of each entry of ``SPECS`` whose group is in ``groups``
    (all when None) and not in ``exclude_groups``, put it in
    ``namespace`` and ``OP_REGISTRY``; returns their names."""
    names = []
    for spec in SPECS:
        g = spec["group"]
        if (groups is not None and g not in groups) or \
                (exclude_groups is not None and g in exclude_groups):
            continue
        api = _make_api(spec)
        OP_REGISTRY[spec["op"]] = namespace[spec["op"]] = api
        names.append(spec["op"])
    return names


def infer_meta(op_name: str, *arg_specs, **attrs):
    """The outputs' shapes and dtypes of the op ``op_name`` on inputs of
    ``arg_specs`` (tensors, or ``(shape, dtype)`` pairs), as tensors of
    the ``meta`` device: its lowering runs without touching data."""
    api = OP_REGISTRY.get(op_name)
    if api is None or not hasattr(api, "raw_fn"):
        raise KeyError(f"no registered lowering for op {op_name!r}")

    def to_meta(a):
        if isinstance(a, torch.Tensor):
            return torch.empty(a.shape, dtype=a.dtype, device="meta")
        if isinstance(a, tuple) and len(a) == 2 and \
                isinstance(a[1], torch.dtype):
            return torch.empty(a[0], dtype=a[1], device="meta")
        return torch.as_tensor(a).to("meta")

    return api.raw_fn(*[to_meta(a) for a in arg_specs], **attrs)
