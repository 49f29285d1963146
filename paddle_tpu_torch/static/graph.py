"""Static-graph capture of the PyTorch port: Program, StaticVar, data,
program_guard, append_backward.

Counterpart of ``paddle_tpu/static/graph.py`` (``:40-343``). Ops applied
to symbolic ``StaticVar`` inputs are captured as a functional DAG of
``OpNode``s; ``Executor.run`` replays it on its device (``executor.py``).
Two routes lead here:

* an op of the port's dispatch (``ops.dispatch.apply_op``) with a
  ``StaticVar`` among its positional arguments, under its own name, as in
  the reference (``ops/dispatch.py:100-102``);
* a torch function or method called on a ``StaticVar`` directly (the
  port's layers call ``x.reshape(...)``, ``x + y``, ``torch.cat``): the
  variable is a ``torch.Tensor`` subclass whose ``__torch_function__``
  records the call under the reference's op name where one exists
  (``Tensor.__add__`` -> ``"add"``, ``permute`` -> ``"transpose"``,
  ``torch.cat`` -> ``"concat"``; ``_TORCH_NAMES``), else under the torch
  name.

Shape inference (the reference's ``jax.eval_shape``, ``:299-310``) runs
the op under ``torch._subclasses.FakeTensorMode``: no data is touched and
no kernel launches (the flash forward, ``paddle_tpu_torch::gqa_fwd``,
answers with its fake implementation). A -1 / None dimension of
``static.data`` runs at the probe extent ``_PROBE``; an output dimension
equal to it is reported as -1 (``:314-320``), and the probe shape is kept
for the ops downstream.

Where the port departs from the reference: a dynamic dimension read from
``.shape`` is a ``DynDim``, an ``int`` equal to -1 that remembers the
variable and axis it came from. An op that takes it as an attribute (the
batch of ``MultiHeadAttention``'s ``x.reshape(B, -1, H, hd)``) runs at the
probe extent during inference and at the fed extent on replay. The
reference passes a bare -1 there, and its capture of a self-attention
layer over a -1 batch raises (two -1 in one reshape).

Reading a value of a ``StaticVar`` (``numpy()``, ``item()``, ``bool()``,
``float()``) raises, as ``:110-113`` does; it has one only inside
``Executor.run``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..core import place as _place
from ..core.dtype import convert_dtype, get_default_dtype

__all__ = [
    "Program", "StaticVar", "GradVar", "DynDim", "data", "program_guard",
    "default_main_program", "default_startup_program", "enable_static",
    "disable_static", "in_static_mode", "append_backward", "gradients",
]

# probe extent substituted for -1/None dims during shape inference; any
# inferred dim equal to it is reported back as -1 (dynamic)
_PROBE = 97


class OpNode:
    """One captured op: the function replay calls, its arguments
    (``StaticVar`` | tensor | ``DynDim`` | Python, possibly nested in
    lists), its attributes, its output variables, and the device
    ``device_guard`` pinned it to (None: the Executor's)."""

    __slots__ = ("name", "fn", "args", "kwargs", "out_vars", "single",
                 "nondiff", "device")

    def __init__(self, name, fn, args, kwargs):
        self.name = name
        self.fn = fn
        self.args = list(args)
        self.kwargs = dict(kwargs)
        self.out_vars: List["StaticVar"] = []
        self.single = True
        self.nondiff = False
        self.device = None


class DynDim(int):
    """A dynamic dimension read from a ``StaticVar``'s shape: the int -1
    that remembers (``var``, ``axis``). Replay substitutes the fed
    extent; shape inference the probe extent. Arithmetic on it gives a
    plain int."""

    def __new__(cls, var, axis):
        d = super().__new__(cls, -1)
        d.var = var
        d.axis = axis
        return d

    def __repr__(self):
        return "-1"


class StaticShape(tuple):
    """A ``StaticVar``'s shape, -1 (``DynDim``) for dynamic dimensions: a
    tuple, as the port's tensors report ``torch.Size``, that also equals
    the reference's list (``x.shape == [-1, 4]``)."""

    def __eq__(self, other):
        if isinstance(other, list):
            other = tuple(other)
        return tuple.__eq__(self, other)

    def __ne__(self, other):
        return not self.__eq__(other)

    __hash__ = tuple.__hash__

    def __add__(self, other):
        return StaticShape(tuple(self) + tuple(other))

    def __radd__(self, other):
        return StaticShape(tuple(other) + tuple(self))

    def __getitem__(self, i):
        out = tuple.__getitem__(self, i)
        return StaticShape(out) if isinstance(i, slice) else out


# torch function / method names -> the reference's op names
_TORCH_NAMES = {
    "__add__": "add", "__radd__": "add", "__iadd__": "add",
    "sub": "subtract", "__sub__": "subtract", "__rsub__": "subtract",
    "rsub": "subtract", "__isub__": "subtract",
    "mul": "multiply", "__mul__": "multiply", "__rmul__": "multiply",
    "__imul__": "multiply",
    "div": "divide", "true_divide": "divide", "__truediv__": "divide",
    "__rtruediv__": "divide", "__itruediv__": "divide",
    "__floordiv__": "floor_divide", "__rfloordiv__": "floor_divide",
    "remainder": "mod", "__mod__": "mod", "__rmod__": "mod",
    "__pow__": "pow", "__rpow__": "pow", "__ipow__": "pow",
    "__neg__": "neg", "negative": "neg", "__abs__": "abs",
    "__matmul__": "matmul", "__rmatmul__": "matmul",
    "eq": "equal", "__eq__": "equal", "ne": "not_equal",
    "__ne__": "not_equal", "lt": "less_than", "__lt__": "less_than",
    "le": "less_equal", "__le__": "less_equal", "gt": "greater_than",
    "__gt__": "greater_than", "ge": "greater_equal",
    "__ge__": "greater_equal",
    "__getitem__": "getitem",
    "view": "reshape", "view_as": "reshape", "reshape_as": "reshape",
    "permute": "transpose", "T": "transpose", "mT": "transpose",
    "transpose": "swapaxes", "swapdims": "swapaxes",
    "cat": "concat", "concatenate": "concat",
    "to": "cast", "type": "cast", "type_as": "cast", "float": "cast",
    "double": "cast", "half": "cast", "bfloat16": "cast", "int": "cast",
    "long": "cast", "bool": "cast",
    "amax": "max", "amin": "min", "clamp": "clip",
    "gather": "take_along_axis",
}
# bitwise dunders take the logical name on bool operands, as the
# reference's (tensor_methods.py:52-57)
_BITWISE = {"__and__": "and", "__or__": "or", "__xor__": "xor",
            "__invert__": "not", "bitwise_and": "and", "bitwise_or": "or",
            "bitwise_xor": "xor", "bitwise_not": "not"}
# attribute getters that read metadata (passed through, never captured)
_META_ATTRS = frozenset((
    "dtype", "device", "requires_grad", "is_cuda", "is_cpu", "is_meta",
    "layout", "is_leaf", "grad_fn", "grad", "is_sparse", "is_quantized",
    "is_mkldnn", "is_nested", "names", "output_nr", "_version",
    "is_sparse_csr", "itemsize", "_base", "retains_grad"))
# methods that read metadata or set a flag
_META_METHODS = frozenset((
    "ndimension", "is_floating_point", "is_complex", "is_signed",
    "element_size", "get_device", "is_contiguous", "requires_grad_",
    "retain_grad", "__hash__", "is_inference", "__setstate__",
    "storage_offset", "has_names", "is_pinned"))


def _op_name(func, args) -> str:
    owner = getattr(getattr(func, "__self__", None), "__name__", None)
    name = owner if getattr(func, "__name__", "") == "__get__" else \
        getattr(func, "__name__", str(func))
    if name in _BITWISE:
        first = args[0] if args else None
        kind = _BITWISE[name]
        if getattr(first, "dtype", None) == torch.bool:
            return f"logical_{kind}"
        return f"bitwise_{kind}"
    return _TORCH_NAMES.get(name, name.strip("_"))


class StaticVar(torch.Tensor):
    """Symbolic variable (~ framework.py Variable): shape and dtype known,
    no value until ``Executor.run``. A ``torch.Tensor`` subclass holding
    no storage (its size is the probe shape; ``.shape`` reports -1 for
    dynamic dimensions); every torch function or method called on it is
    captured while static mode is on."""

    _symbolic = True
    _counter = 0

    @staticmethod
    def __new__(cls, shape, dtype, name=None, node=None, out_index=0,
                is_data=False, device=None, probe_shape=None):
        shape = tuple(-1 if (d is None or int(d) < 0) else int(d)
                      for d in shape)
        probe = tuple(probe_shape) if probe_shape is not None else \
            tuple(_PROBE if d == -1 else d for d in shape)
        dev = torch.device(device) if device is not None else \
            _place._default
        self = torch.Tensor._make_wrapper_subclass(
            cls, probe, dtype=convert_dtype(dtype), device=dev)
        self._shape = shape
        self._probe_shape = probe
        self._node: Optional[OpNode] = node
        self._output_index = out_index
        self.is_data = is_data
        self.persistable = False
        if name is None:
            name = f"_generated_var_{StaticVar._counter}"
            StaticVar._counter += 1
        self._var_name = name
        return self

    def __init__(self, *args, **kwargs):
        pass

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fname = getattr(func, "__name__", "")
        if fname in ("__get__", "__set__"):
            owner = getattr(getattr(func, "__self__", None), "__name__", "")
            if owner in _META_ATTRS or fname == "__set__":
                with torch._C.DisableTorchFunctionSubclass():
                    return func(*args, **kwargs)
        elif fname in _META_METHODS:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        elif fname in ("size", "dim", "numel", "__len__"):
            # reached unbound (torch.numel(x), Tensor.size(x)): the
            # variable's own answer, -1 for a dynamic dimension
            return getattr(args[0], fname)(*args[1:], **kwargs)
        if fname == "backward":
            raise RuntimeError(
                "backward() on a StaticVar: a static program takes its "
                "gradients from static.append_backward / gradients or "
                "Optimizer.minimize, computed by Executor.run")
        if fname.endswith("_") and not fname.endswith("__") and \
                args and isinstance(args[0], StaticVar):
            raise RuntimeError(
                f"in-place '{fname}' on StaticVar '{args[0].name}': a "
                "captured op makes a new variable; use the out-of-place "
                "form")
        from ..ops import dispatch as _d
        if not _d.STATIC_MODE:
            raise RuntimeError(
                f"'{fname}' on a StaticVar outside static mode: call "
                "paddle.enable_static() before building the program")
        return capture(_op_name(func, args), func, args, kwargs)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(
            f"{func} reached a StaticVar below the capture: a StaticVar "
            "holds no data (fetch it through Executor.run)")

    # ---- what the variable reports ----------------------------------------
    @property
    def name(self):
        return self._var_name

    @name.setter
    def name(self, value):
        self._var_name = value

    @property
    def shape(self):
        return StaticShape(DynDim(self, i) if d == -1 else d
                           for i, d in enumerate(self._shape))

    @property
    def ndim(self):
        return len(self._shape)

    def size(self, dim=None):
        shape = self.shape
        return shape if dim is None else shape[dim]

    def dim(self):
        return len(self._shape)

    def numel(self):
        if -1 in self._shape:
            return -1
        n = 1
        for d in self._shape:
            n *= d
        return n

    def __len__(self):
        if not self._shape or self._shape[0] == -1:
            raise TypeError(f"len() of StaticVar '{self.name}' with a "
                            "dynamic first dimension")
        return self._shape[0]

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def _no_value(self, *args, **kwargs):
        raise RuntimeError(
            f"StaticVar '{self.name}' is symbolic; fetch it via "
            "Executor.run(fetch_list=[var]) to get a value")

    numpy = item = tolist = __bool__ = __float__ = __int__ = __index__ = \
        __array__ = __complex__ = _no_value

    def __repr__(self):
        return (f"StaticVar(name={self.name}, shape={list(self._shape)}, "
                f"dtype={str(self.dtype).removeprefix('torch.')})")

    __str__ = __repr__

    def __format__(self, spec):
        return repr(self)

    def __hash__(self):
        return id(self)

    def __reduce_ex__(self, protocol):
        raise TypeError(f"StaticVar '{self.name}' cannot be pickled")


class GradVar(StaticVar):
    """Symbolic gradient d(loss)/d(wrt) (~ the grad vars append_backward
    creates, fluid/backward.py). ``wrt`` is a parameter or a data
    StaticVar; the executor computes it with ``torch.autograd.grad``."""

    @staticmethod
    def __new__(cls, loss, wrt):
        shape = wrt._shape if isinstance(wrt, StaticVar) \
            else tuple(wrt.shape)
        nm = getattr(wrt, "name", None) if isinstance(wrt, StaticVar) \
            else getattr(wrt, "param_name", None)
        self = StaticVar.__new__(cls, shape, wrt.dtype,
                                 name=f"{nm or 'w'}@GRAD", device=wrt.device)
        self.loss = loss
        self.wrt = wrt
        return self


class Program:
    """~ fluid.Program (framework.py): the captured graph + its parameters +
    appended optimizer steps. There is one flat block."""

    _counter = 0

    def __init__(self):
        self._datas: Dict[str, StaticVar] = {}
        self._vars: Dict[str, StaticVar] = {}
        self._params: List[torch.Tensor] = []
        self._param_ids = set()
        self._opts: List[tuple] = []     # (optimizer, loss_var, params|None)
        self._layers: List[Any] = []     # static.nn layers kept alive
        self._n_ops = 0
        self._version = 0
        self._param_snapshot: Optional[Dict[int, torch.Tensor]] = None
        self.random_seed = 0
        self.id = Program._counter
        Program._counter += 1

    # ---- registration ------------------------------------------------------
    def _add_param(self, p):
        if id(p) not in self._param_ids:
            self._param_ids.add(id(p))
            self._params.append(p)
            self._version += 1

    def _add_var(self, v: StaticVar):
        self._vars[v.name] = v

    def _append_opt(self, optimizer, loss, parameters=None):
        self._opts.append((optimizer, loss, parameters))
        self._version += 1

    # ---- paddle API compat -------------------------------------------------
    def global_block(self):
        return self

    @property
    def blocks(self):
        return [self]

    def all_parameters(self):
        return list(self._params)

    def list_vars(self):
        return list(self._datas.values()) + list(self._vars.values())

    def var(self, name):
        if name in self._datas:
            return self._datas[name]
        if name in self._vars:
            return self._vars[name]
        for p in self._params:
            if getattr(p, "param_name", None) == name:
                return p
        raise KeyError(f"no var named {name!r} in program")

    def has_var(self, name):
        return name in self._datas or name in self._vars

    def clone(self, for_test: bool = False):
        # vars are shared; cloning is a view (the reference's)
        c = Program.__new__(Program)
        c.__dict__ = dict(self.__dict__)
        c.id = Program._counter  # distinct executor cache identity
        Program._counter += 1
        if for_test:
            c._opts = []
        return c

    def __repr__(self):
        return (f"Program(id={self.id}, datas={list(self._datas)}, "
                f"params={len(self._params)}, ops={self._n_ops}, "
                f"opt_steps={len(self._opts)})")


_default_main = Program()
_default_startup = Program()
_static_mode = False
_pinned: Optional[torch.device] = None   # set by extras.device_guard


def default_main_program() -> Program:
    return _default_main


def default_startup_program() -> Program:
    return _default_startup


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Program = None):
    """~ fluid.program_guard."""
    global _default_main, _default_startup
    old_m, old_s = _default_main, _default_startup
    _default_main = main_program
    if startup_program is not None:
        _default_startup = startup_program
    try:
        yield
    finally:
        _default_main, _default_startup = old_m, old_s


def enable_static():
    """~ paddle.enable_static: ops touching a StaticVar are captured."""
    global _static_mode
    _static_mode = True
    from ..ops import dispatch as _d
    _d.STATIC_MODE = True


def disable_static(place=None):
    global _static_mode
    _static_mode = False
    from ..ops import dispatch as _d
    _d.STATIC_MODE = False


def in_static_mode() -> bool:
    return _static_mode


def data(name: str, shape: Sequence[int], dtype=None,
         lod_level=0) -> StaticVar:
    """~ paddle.static.data: a feed slot of the default main program, on
    the default device."""
    if dtype is None:
        dtype = get_default_dtype()
    v = StaticVar(shape, dtype, name=name, is_data=True)
    v.requires_grad_(False)
    default_main_program()._datas[name] = v
    return v


def _is_symbolic(x) -> bool:
    return isinstance(x, StaticVar)


def _leaves(x, out):
    """The leaves of ``x`` through lists, tuples and dicts, into ``out``."""
    if isinstance(x, (list, tuple)):
        for e in x:
            _leaves(e, out)
    elif isinstance(x, dict):
        for e in x.values():
            _leaves(e, out)
    else:
        out.append(x)
    return out


def _map(f, x):
    """``x`` with each leaf through ``f`` (lists, tuples, dicts kept; a
    torch.Size or a StaticShape becomes a tuple)."""
    if isinstance(x, list):
        return [_map(f, e) for e in x]
    if isinstance(x, tuple) and not isinstance(x, torch.Tensor):
        vals = [_map(f, e) for e in x]
        if hasattr(x, "_fields"):
            return type(x)(*vals)
        return tuple(vals)
    if isinstance(x, dict):
        return {k: _map(f, e) for k, e in x.items()}
    return f(x)


def _infer(fn, args, kwargs, pinned):
    """Run ``fn`` on fake tensors: StaticVars at their probe shapes, a
    DynDim at its probe extent, real tensors converted (moved to the
    pinned device when there is one)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(a):
        if isinstance(a, StaticVar):
            return torch.empty(a._probe_shape, dtype=a.dtype,
                               device=pinned or a.device)
        if isinstance(a, DynDim):
            return a.var._probe_shape[a.axis]
        if pinned is not None and isinstance(a, torch.Tensor):
            return a.to(pinned)
        return a

    with mode:
        return fn(*_map(fake, list(args)), **_map(fake, dict(kwargs)))


def capture(name: str, fn, args, kwargs, nondiff=False):
    """Append one op to the default main program (~ LayerHelper.append_op
    -> block.append_op). Infers the outputs on fake tensors (the infermeta
    role) and returns StaticVars (a tensor output) in ``fn``'s output
    structure."""
    prog = default_main_program()
    leaves = _leaves([list(args), dict(kwargs)], [])
    probing = False
    for a in leaves:
        if isinstance(a, torch.nn.Parameter):
            prog._add_param(a)
            # the paired startup program owns initialization state
            default_startup_program()._add_param(a)
        elif isinstance(a, DynDim) or (isinstance(a, StaticVar)
                                       and -1 in a._shape):
            probing = True
    out = _infer(fn, args, kwargs, _pinned)

    node = OpNode(name, fn, args, kwargs)
    node.nondiff = bool(nondiff)
    node.device = _pinned

    def wrap(pos, o):
        if not isinstance(o, torch.Tensor):
            return o
        shp = [(-1 if (probing and d == _PROBE) else int(d))
               for d in o.shape]
        v = StaticVar(shp, o.dtype, node=node, out_index=pos,
                      device=o.device, probe_shape=tuple(o.shape))
        node.out_vars.append(v)
        prog._add_var(v)
        return v

    if isinstance(out, (tuple, list)):
        node.single = False
        outs = [wrap(i, o) for i, o in enumerate(out)]
        result = outs if isinstance(out, list) else (
            type(out)(outs) if hasattr(out, "n_fields") else tuple(outs))
    else:
        result = wrap(0, out)
    prog._n_ops += 1
    prog._version += 1
    return result


def append_backward(loss: StaticVar, parameter_list=None, no_grad_set=None):
    """~ fluid.backward.append_backward: returns [(param, grad_var)]."""
    prog = default_main_program()
    params = parameter_list if parameter_list is not None else prog._params
    params = [p for p in params
              if isinstance(p, torch.nn.Parameter) and p.requires_grad]
    return [(p, GradVar(loss, p)) for p in params]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """~ paddle.static.gradients: symbolic grads of targets wrt inputs."""
    tgts = targets if isinstance(targets, (list, tuple)) else [targets]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    assert len(tgts) == 1, "gradients() supports a single scalar target"
    return [GradVar(tgts[0], x) for x in ins]
