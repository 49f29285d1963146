"""Runtime converters the transformed AST calls into.

Counterpart of ``paddle_tpu/jit/dy2static/convert_operators.py``
(``convert_ifelse`` :94, ``convert_while_loop`` :131, the logicals
:161-193, ``convert_print``, ``convert_assert``, ``convert_var_dtype``,
``convert_len``, ``UndefinedVar``). Each checks whether its control value
is a tensor of a program being captured: then the control flow is
captured too (``torch.cond``, ``torch._higher_order_ops.while_loop``);
else it runs natively, as in the reference, which takes a concrete
predicate's branch in Python (``:108-110``).

"Captured" is the port's own flag, not a property of the tensor:
``capturing()`` sets it while ``jit.StaticFunction`` (or a caller) exports
a program, and a tensor predicate under it goes to ``torch.cond``. Outside
it a tensor predicate is read (``bool``) and its branch taken. A capture
that cannot hold the control flow raises; nothing re-runs eagerly.

Carried values follow the reference's partition: tensors and Python
scalars ride through the captured control flow (a scalar becomes a 0-d
tensor, of its partner's dtype where the other side is a tensor, as JAX
makes it an array), ``UndefinedVar`` temps and other objects pass around
it. Under capture ``print`` and ``assert`` become the operators
``paddle_tpu_torch::dy2static_print`` / ``dy2static_assert``, which run
with the program (the reference's host callbacks); the assert raises
``AssertionError`` on the host when its value is false.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.fx
import torch.utils._pytree as pytree

__all__ = ["UndefinedVar", "capturing", "is_capturing", "convert_ifelse",
           "convert_while_loop", "convert_logical_and", "convert_logical_or",
           "convert_logical_not", "convert_print", "convert_assert",
           "convert_var_dtype", "convert_len", "while_loop_op",
           "captured_cond"]

_capture = contextvars.ContextVar("paddle_tpu_torch_capture", default=False)


@contextlib.contextmanager
def capturing():
    """Mark the program traced inside as captured: tensor control flow
    becomes ``torch.cond`` / ``while_loop``."""
    token = _capture.set(True)
    try:
        yield
    finally:
        _capture.reset(token)


def is_capturing() -> bool:
    """Inside ``capturing()``, or inside a branch or loop body that
    ``torch.cond`` / ``while_loop`` is tracing (dynamo traces those, and
    a ``ContextVar`` is opaque to it: the first test answers there)."""
    return torch.compiler.is_dynamo_compiling() or _capture.get()


def while_loop_op():
    """``torch._higher_order_ops.while_loop``: a private API of PyTorch,
    refused by name where the installed PyTorch lacks it (a loop is never
    unrolled in its place)."""
    try:
        from torch._higher_order_ops.while_loop import while_loop
    except ImportError as e:
        raise NotImplementedError(
            f"a tensor-bounded loop under capture needs "
            f"torch._higher_order_ops.while_loop, which PyTorch "
            f"{torch.__version__} lacks") from e
    return while_loop


class UndefinedVar:
    """Sentinel for names that may be defined only inside a branch
    (~ dygraph_to_static/utils.py UndefinedVar)."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"UndefinedVar({self.name!r})"


def _traced(x) -> bool:
    return isinstance(x, torch.Tensor) and is_capturing()


def _pred(x):
    """A tensor predicate as one bool: all of it, as the reference's
    ``jnp.all``."""
    if x.dim() > 0:
        x = x.all()
    return x if x.dtype == torch.bool else x != 0


def _partition(carry):
    """Split the carry tuple into the captured subset (tensors and Python
    scalars) and static passthrough values (UndefinedVar temps, strings,
    arbitrary objects), as the reference does."""
    flat = list(carry)
    dyn_idx = [i for i, v in enumerate(flat)
               if isinstance(v, (torch.Tensor, int, float, bool, complex))
               and not isinstance(v, UndefinedVar)]
    return flat, dyn_idx


def _to_full(flat, dyn_idx, sub):
    out = list(flat)
    for j, i in enumerate(dyn_idx):
        out[i] = sub[j]
    return tuple(out)


def _as_tensor(v, like=None, device=None):
    """A carried value as a tensor: a Python scalar becomes a 0-d tensor
    of ``like``'s dtype and device where ``like`` is a tensor, else on
    ``device`` (the predicate's)."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(like, torch.Tensor):
        return torch.tensor(v, dtype=like.dtype, device=like.device)
    return torch.tensor(v, device=device)


def _fresh(outs, ins):
    """Outputs of a captured branch or body, none of them one of its
    inputs (a captured subgraph may not return an input as it is). By
    ``is``, which dynamo follows on tensors; it refuses ``id()``."""
    fresh = []
    for o in outs:
        for t in ins:
            if o is t:
                o = o.clone()
                break
        fresh.append(o)
    return tuple(fresh)


def convert_ifelse(pred, true_fn, false_fn, carry):
    """``out = convert_ifelse(cond, true_fn, false_fn, (a, b))``.

    A tensor predicate under capture -> ``torch.cond`` with both branches
    captured over the carry; otherwise the taken branch only."""
    if isinstance(pred, torch.Tensor):
        if not is_capturing():
            # a concrete tensor: take one branch natively
            return true_fn(carry) if bool(_pred(pred)) else false_fn(carry)
        flat, dyn_idx = _partition(carry)
        sub0 = tuple(_as_tensor(flat[i], device=pred.device)
                     for i in dyn_idx)

        def run(branch_fn, *sub):
            out = branch_fn(_to_full(flat, dyn_idx, sub))
            out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            for v in out:
                if isinstance(v, UndefinedVar):
                    raise ValueError(
                        f"variable '{v.name}' must be defined in both "
                        "branches of a tensor-dependent `if` (or before "
                        "it) for compiled control flow")
            like = _to_full(flat, dyn_idx, sub)
            return tuple(_as_tensor(v, like[i] if i < len(like) else None)
                         for i, v in enumerate(out))

        return tuple(captured_cond(pred, lambda *s: run(true_fn, *s),
                                   lambda *s: run(false_fn, *s), sub0))
    return true_fn(carry) if pred else false_fn(carry)


def captured_cond(pred, true_fn, false_fn, operands=()):
    """``torch.cond`` of the tensor ``pred`` over ``operands`` (tensors,
    or Python scalars made 0-d tensors): each branch returns a tree of
    tensors (a Python scalar made one), none of them an operand."""
    ops = tuple(_as_tensor(o, device=pred.device) for o in operands)

    def branch(fn):
        def run(*sub):
            leaves, spec = pytree.tree_flatten(fn(*sub))
            leaves = _fresh([_as_tensor(v, device=pred.device)
                             for v in leaves], sub)
            return pytree.tree_unflatten(list(leaves), spec)
        return run

    return torch.cond(_pred(pred), branch(true_fn), branch(false_fn), ops)


def convert_while_loop(cond_fn, body_fn, carry):
    """Tensor-valued condition under capture -> ``while_loop``; else a
    native while."""
    probe = cond_fn(carry)
    if _traced(probe):
        flat, dyn_idx = _partition(carry)
        sub0 = tuple(_as_tensor(flat[i], device=probe.device)
                     for i in dyn_idx)

        def cond(*sub):
            r = cond_fn(_to_full(flat, dyn_idx, sub))
            return _pred(r) if isinstance(r, torch.Tensor) \
                else torch.tensor(bool(r), device=probe.device)

        def body(*sub):
            out = body_fn(_to_full(flat, dyn_idx, sub))
            out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            return _fresh([_as_tensor(out[i], sub[j])
                           for j, i in enumerate(dyn_idx)], sub)

        res = while_loop_op()(cond, body, sub0)
        return _to_full(flat, dyn_idx, tuple(res))
    while _bool(probe):
        carry = body_fn(carry)
        probe = cond_fn(carry)
    return carry


def _bool(x):
    if isinstance(x, torch.Tensor):
        return bool(x.all())
    return bool(x)


def _logical(op, lhs, rhs):
    rhs = rhs if isinstance(rhs, torch.Tensor) else bool(rhs)
    return op(lhs, torch.as_tensor(rhs, device=lhs.device))


def convert_logical_and(lhs_fn, rhs_fn):
    """``a and b`` with tensor short-circuit semantics preserved for
    Python values (rhs not evaluated when lhs falsy and plain)."""
    lhs = lhs_fn()
    if isinstance(lhs, torch.Tensor):
        return _logical(torch.logical_and, lhs, rhs_fn())
    if not lhs:
        return lhs
    return rhs_fn()


def convert_logical_or(lhs_fn, rhs_fn):
    lhs = lhs_fn()
    if isinstance(lhs, torch.Tensor):
        return _logical(torch.logical_or, lhs, rhs_fn())
    if lhs:
        return lhs
    return rhs_fn()


def convert_logical_not(x):
    if isinstance(x, torch.Tensor):
        return torch.logical_not(x)
    return not x


@torch.library.custom_op("paddle_tpu_torch::dy2static_print", mutates_args=())
def _print_op(xs: list[torch.Tensor], fmt: str) -> None:
    print(fmt.format(*xs))


@_print_op.register_fake
def _print_fake(xs, fmt):
    return None


@torch.library.custom_op("paddle_tpu_torch::dy2static_assert",
                         mutates_args=())
def _assert_op(ok: torch.Tensor, msg: str) -> None:
    if not bool(ok):
        raise AssertionError(msg)


@_assert_op.register_fake
def _assert_fake(ok, msg):
    return None


# neither returns a value: keep them in a captured program all the same
torch.fx.node.has_side_effect(torch.ops.paddle_tpu_torch.dy2static_print.default)
torch.fx.node.has_side_effect(
    torch.ops.paddle_tpu_torch.dy2static_assert.default)


def convert_print(*args):
    """~ print_transformer.py convert_print: under capture the tensors
    print when the program runs (the ``dy2static_print`` operator, the
    reference's ``jax.debug.print``); otherwise natively."""
    if any(_traced(a) for a in args):
        fmt = " ".join("{}" if isinstance(a, torch.Tensor)
                       else str(a).replace("{", "{{").replace("}", "}}")
                       for a in args)
        _print_op([a for a in args if isinstance(a, torch.Tensor)], fmt)
        return
    print(*args)


def convert_assert(test, msg=None):
    """~ assert_transformer.py convert_assert (Assert op). Under capture
    the ``dy2static_assert`` operator raises AssertionError when the
    program runs with a false value; otherwise native assert semantics."""
    if _traced(test):
        _assert_op(_pred(test), "dy2static assert failed" if msg is None
                   else str(msg))
        return
    ok = _bool(test)
    if not ok:
        raise AssertionError(msg if msg is not None else None)


_CASTS = {"bool": bool, "int": int, "float": float}


def convert_var_dtype(x, dtype_name: str):
    """~ cast_transformer.py: bool/int/float(x) on a tensor becomes a
    dtype cast that survives capture; a concrete 0-d tensor keeps native
    Python cast semantics so eager behavior is unchanged. int is int64,
    the reference cast_transformer's type (the JAX package narrows it to
    int32 without x64)."""
    if isinstance(x, torch.Tensor):
        if not is_capturing() and x.dim() == 0:
            return _CASTS[dtype_name](x)
        target = {"bool": torch.bool, "int": torch.int64,
                  "float": torch.float32}[dtype_name]
        return x.to(target)
    return _CASTS[dtype_name](x)


def convert_len(x):
    """~ convert_operators.py convert_len: leading-dim length for tensors
    (static under capture), native len() for containers."""
    if isinstance(x, torch.Tensor):
        return x.shape[0]
    return len(x)
