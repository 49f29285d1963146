"""Inputs for every op of the op namespace, shared by the CPU sweep
against the JAX package (``test_torch_ops.py``) and the card sweep
against the CPU (``test_torch_kernels_cuda.py``, ``chip_smoke.py``'s
reference phase). Imports numpy only.

``CASES`` maps a case id (the op's public name in ``ops``, or name[variant])
to a ``Case``: ``make(rng)`` gives (args, kwargs), whose ndarrays become
tensors (``Raw`` ones stay ndarrays; ndarrays inside lists and tuples
become tensors too); ``tol`` is "exact" (integers and bools, and floats
that are copies or exact selections), "f32" (1e-6 abs + 1e-6 rel) or
"trans" (1e-5 rel + 1e-6 abs: transcendental functions and sums whose
order of terms may differ, a few ulps); ``grad`` whether the float inputs'
gradients are compared too (a fixed random cotangent on every float
output). ``rng`` is seeded from the id (crc32), so a case's inputs do not
depend on which other cases run.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

TOLS = {"exact": (0.0, 0.0), "f32": (1e-6, 1e-6), "trans": (1e-6, 1e-5)}
GRAD_TOL = (1e-5, 1e-5)


class Raw:
    """An ndarray passed to the op as an ndarray."""

    def __init__(self, a):
        self.a = a


@dataclass
class Case:
    make: Callable
    tol: str = "f32"
    grad: bool = True
    fn: str | None = None
    extra: dict = field(default_factory=dict)


def rng_for(cid: str):
    return np.random.default_rng(zlib.crc32(cid.encode()))


def S(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def U(r, lo, hi, *shape):
    return r.uniform(lo, hi, shape).astype(np.float32)


def P(r, *shape):
    return U(r, 0.2, 2.0, *shape)


def I(r, lo, hi, *shape):
    return r.integers(lo, hi, shape).astype(np.int32)


def B(r, *shape):
    return r.random(shape) < 0.5


def away(r, *shape):
    x = U(r, 0.3, 1.5, *shape)
    return x * np.where(r.random(shape) < 0.5, -1, 1).astype(np.float32)


def spd(r, n):
    a = S(r, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def well(r, n):
    return (S(r, n, n) + 3 * np.eye(n)).astype(np.float32)


def with_nans(r, *shape):
    x = S(r, *shape)
    x.reshape(-1)[::5] = np.nan
    return x


CASES: dict = {}


def case(cid, make, tol="f32", grad=True, fn=None, **extra):
    CASES[cid] = Case(make, tol, grad, fn, extra)


def _x(gen, **kw):
    return lambda r: ([gen(r)], kw)


def _xy(gx, gy, **kw):
    return lambda r: ([gx(r), gy(r)], kw)


s23 = lambda r: S(r, 2, 3)  # noqa: E731
s34 = lambda r: S(r, 3, 4)  # noqa: E731

# ---- the spec table's default group ---------------------------------------
case("logaddexp2", _xy(s23, s23), "trans")
case("rot90_k2", _x(s34), "exact")
case("sinc", _x(lambda r: away(r, 2, 3)), "trans")
case("i0", _x(s23), "trans")
case("i1", _x(s23), "trans")
case("polygamma", _x(lambda r: P(r, 2, 3), n=1), "trans")
case("xlogy", _xy(lambda r: P(r, 2, 3), lambda r: P(r, 2, 3)), "trans")
case("ldexp", lambda r: ([S(r, 2, 3), I(r, -3, 4, 2, 3)], {}), "exact")
case("vander", _x(lambda r: S(r, 4), n=3))
case("trapezoid", _x(s34, dx=0.5, axis=-1))
case("unwrap", _x(lambda r: U(r, -9, 9, 2, 6), axis=-1), "trans")
case("diff", _x(lambda r: S(r, 3, 5), n=2, axis=-1))
case("cummax", _x(lambda r: S(r, 3, 5), axis=1), "exact")
case("cummin", _x(lambda r: S(r, 3, 5), axis=0), "exact")
case("renorm", _x(lambda r: S(r, 3, 4), p=2.0, axis=0, max_norm=1.0),
     "trans")
case("frexp", _x(lambda r: S(r, 2, 3) * 9), "exact", grad=False)

# ---- elementwise binary ---------------------------------------------------
for name in ("add", "subtract", "multiply", "maximum", "minimum", "fmax",
             "fmin"):
    case(name, _xy(s23, lambda r: S(r, 3)))
case("divide", _xy(s23, lambda r: away(r, 2, 3)))
case("floor_divide", _xy(lambda r: S(r, 2, 3) * 5, lambda r: away(r, 2, 3)),
     grad=False)
case("mod", _xy(lambda r: S(r, 2, 3) * 5, lambda r: away(r, 2, 3)))
case("remainder", _xy(lambda r: I(r, -20, 20, 2, 3), lambda r: I(r, 1, 7, 3)),
     "exact")
case("pow", _xy(lambda r: P(r, 2, 3), lambda r: S(r, 2, 3)), "trans")
case("pow_", _xy(lambda r: P(r, 2, 3), lambda r: U(r, -2, 2, 2, 3)),
     "trans")
case("atan2", _xy(s23, s23), "trans")
case("hypot", _xy(s23, s23), "trans")
case("logaddexp", _xy(s23, s23), "trans")
case("nextafter", _xy(s23, s23), "exact", grad=False)
case("copysign", _xy(s23, s23), "exact")
case("heaviside", _xy(lambda r: np.round(S(r, 2, 3)), s23), "exact",
     grad=False)
case("gcd", _xy(lambda r: I(r, -30, 30, 2, 3), lambda r: I(r, 0, 30, 2, 3)),
     "exact")
case("lcm", _xy(lambda r: I(r, -30, 30, 2, 3), lambda r: I(r, 0, 30, 2, 3)),
     "exact")
case("add[scalar]", lambda r: ([S(r, 2, 3), 1.5], {}), fn="add")
case("multiply[int]", lambda r: ([I(r, -5, 5, 2, 3), 3], {}), "exact",
     fn="multiply")

# ---- elementwise unary ----------------------------------------------------
_UNARY = {
    "exp": s23, "expm1": s23, "log": lambda r: P(r, 2, 3),
    "log2": lambda r: P(r, 2, 3), "log10": lambda r: P(r, 2, 3),
    "log1p": lambda r: P(r, 2, 3), "sqrt": lambda r: P(r, 2, 3),
    "rsqrt": lambda r: P(r, 2, 3), "square": s23, "abs": s23, "sign": s23,
    "neg": s23, "reciprocal": lambda r: away(r, 2, 3),
    "floor": lambda r: S(r, 2, 3) * 3, "ceil": lambda r: S(r, 2, 3) * 3,
    "round": lambda r: S(r, 2, 3) * 3, "trunc": lambda r: S(r, 2, 3) * 3,
    "frac": lambda r: S(r, 2, 3) * 3, "sin": s23, "cos": s23,
    "tan": lambda r: U(r, -1.2, 1.2, 2, 3), "asin": lambda r: U(r, -.9, .9, 2, 3),
    "acos": lambda r: U(r, -.9, .9, 2, 3), "atan": s23, "sinh": s23,
    "cosh": s23, "tanh": s23, "asinh": s23,
    "acosh": lambda r: U(r, 1.2, 3, 2, 3),
    "atanh": lambda r: U(r, -.9, .9, 2, 3), "erf": s23,
    "erfinv": lambda r: U(r, -.9, .9, 2, 3), "lgamma": lambda r: P(r, 2, 3),
    "digamma": lambda r: P(r, 2, 3), "deg2rad": s23, "rad2deg": s23,
    "angle": s23, "conj": s23, "real": s23, "imag": s23,
}
_EXACT_UNARY = {"abs", "sign", "neg", "floor", "ceil", "round", "trunc",
                "square", "conj", "real", "imag", "angle"}
_NO_GRAD_UNARY = {"sign", "floor", "ceil", "round", "trunc", "angle",
                  "imag"}
for name, gen in _UNARY.items():
    case(name, _x(gen), "exact" if name in _EXACT_UNARY else "trans",
         grad=name not in _NO_GRAD_UNARY)

# ---- activations ----------------------------------------------------------
for name in ("relu", "relu6", "sigmoid", "hardsigmoid", "hardswish",
             "hardtanh", "hardshrink", "softshrink", "tanhshrink", "silu",
             "swish", "mish", "softplus", "softsign", "log_sigmoid", "elu",
             "selu", "celu", "gelu", "thresholded_relu"):
    case(name, _x(lambda r: S(r, 3, 4) * 3), "trans")
case("leaky_relu", lambda r: ([S(r, 3, 4), 0.1], {}), "trans")
case("prelu", _xy(s34, lambda r: U(r, 0.1, 0.3, 4)))
case("softmax", _x(s34, axis=0), "trans")
case("log_softmax", _x(s34, axis=-1), "trans")
case("gumbel_softmax", _x(s34, temperature=0.5), "trans")
case("maxout", _x(lambda r: S(r, 2, 6, 3), groups=2, axis=1), "exact")
case("glu", _x(lambda r: S(r, 3, 4), axis=-1), "trans")

# ---- the rest of math -----------------------------------------------------
case("clip", _x(s34, min=-0.5, max=0.5), "exact")
case("lerp", lambda r: ([S(r, 3), S(r, 3), U(r, 0, 1, 3)], {}))
case("stanh", _x(s34), "trans")
case("scale", _x(s34, scale=2.0, bias=0.5, bias_after_scale=False))
case("multiplex", lambda r: ([[S(r, 4, 3), S(r, 4, 3)],
                              I(r, 0, 2, 4, 1)], {}), "exact")
case("addmm", lambda r: ([S(r, 2, 4), S(r, 2, 3), S(r, 3, 4)],
                         {"beta": 0.5, "alpha": 2.0}), "trans")
case("inner", _xy(s34, s34), "trans")
case("outer", _xy(lambda r: S(r, 3), lambda r: S(r, 4)))
case("kron", _xy(lambda r: S(r, 2, 2), lambda r: S(r, 2, 3)))
case("trace", _x(lambda r: S(r, 4, 4), offset=1), "trans")
case("diagonal", _x(lambda r: S(r, 3, 4, 4), offset=-1, axis1=1, axis2=2),
     "exact")
case("cumsum", _x(s34, axis=1), "trans")
case("cumprod", _x(s34, dim=0), "trans")
case("logcumsumexp", _x(s34, axis=None), "trans")
for name in ("isfinite", "isinf", "isnan"):
    case(name, _x(lambda r: np.array([1.0, np.inf, -np.inf, np.nan, 0.5],
                                     np.float32)), "exact", grad=False)
for name in ("logical_and", "logical_or", "logical_xor"):
    case(name, _xy(lambda r: B(r, 3, 4), lambda r: B(r, 3, 4)), "exact",
         grad=False)
case("logical_not", _x(lambda r: B(r, 3, 4)), "exact", grad=False)
for name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    case(name, _xy(lambda r: I(r, -50, 50, 3, 4), lambda r: I(r, 0, 50, 4)),
         "exact", grad=False)
case("bitwise_not", _x(lambda r: I(r, -50, 50, 3, 4)), "exact", grad=False)
case("left_shift", _xy(lambda r: I(r, 0, 50, 3, 4), lambda r: I(r, 0, 5, 4)),
     "exact", grad=False)
case("right_shift", _xy(lambda r: I(r, 0, 500, 3, 4),
                        lambda r: I(r, 0, 5, 4)), "exact", grad=False)
for name in ("equal", "not_equal", "greater_than", "greater_equal",
             "less_than", "less_equal"):
    case(name, _xy(lambda r: I(r, 0, 3, 3, 4), lambda r: I(r, 0, 3, 4)),
         "exact", grad=False)
case("equal[float_scalar]", lambda r: ([np.float32([1.0, 2.0, 2.5]), 2.0],
                                       {}), "exact", grad=False, fn="equal")
case("equal_all", _xy(lambda r: I(r, 0, 2, 3), lambda r: I(r, 0, 2, 3)),
     "exact", grad=False)
case("allclose", lambda r: ([np.float32([1.0, 2.0]),
                             np.float32([1.0, 2.00001])], {}), "exact",
     grad=False)
case("isclose", lambda r: ([np.float32([1.0, 2.0, 3.0]),
                            np.float32([1.0, 2.001, 3.00001])], {}), "exact",
     grad=False)
case("where", lambda r: ([B(r, 3, 4), S(r, 3, 4), S(r, 4)], {}), "exact")
case("where[scalar]", lambda r: ([B(r, 3, 4), S(r, 3, 4), 0.5], {}), "exact",
     fn="where")
case("nan_to_num", _x(lambda r: np.float32([1.0, np.nan, np.inf, -np.inf]),
                      nan=0.5, posinf=9.0), "exact")

# ---- reductions -----------------------------------------------------------
for name in ("sum", "mean", "max", "min", "amax", "amin", "nansum",
             "nanmean", "logsumexp"):
    case(name, _x(lambda r: S(r, 2, 3, 4), axis=[0, 2], keepdim=True),
         "trans")
case("sum[int]", _x(lambda r: I(r, -9, 9, 3, 4), axis=1), "exact", fn="sum")
case("sum[all]", _x(lambda r: S(r, 3, 4)), "trans", fn="sum")
case("mean[int]", _x(lambda r: I(r, -9, 9, 3, 4)), "trans", fn="mean")
case("prod", _x(lambda r: U(r, 0.5, 1.5, 2, 3, 4), axis=1), "trans")
case("any", _x(lambda r: B(r, 3, 4), axis=1), "exact", grad=False)
case("all", _x(lambda r: B(r, 3, 4), axis=None), "exact", grad=False)
case("nansum[nan]", _x(lambda r: with_nans(r, 3, 4), axis=1), "trans",
     fn="nansum")
case("median", _x(lambda r: S(r, 3, 4), axis=1), "trans")
case("median[odd_all]", _x(lambda r: S(r, 3, 5)), "trans", fn="median")
case("nanmedian", _x(lambda r: with_nans(r, 3, 5), axis=1), "trans")
case("std", _x(lambda r: S(r, 3, 4), axis=1, unbiased=True), "trans")
case("var", _x(lambda r: S(r, 3, 4), axis=None, unbiased=False), "trans")
case("argmax", _x(lambda r: S(r, 3, 4), axis=1), "exact", grad=False)
case("argmin", _x(lambda r: S(r, 3, 4)), "exact", grad=False)
case("count_nonzero", _x(lambda r: I(r, 0, 2, 3, 4), axis=1, keepdim=True),
     "exact", grad=False)
case("quantile", lambda r: ([S(r, 3, 5)], {"q": [0.25, 0.5], "axis": 1}),
     "trans")
case("kthvalue", _x(lambda r: S(r, 3, 5), k=2, axis=1), "exact")
case("mode", _x(lambda r: S(r, 3, 5), axis=1), "exact")

# ---- manipulation ---------------------------------------------------------
case("reshape", _x(lambda r: S(r, 2, 3, 4), shape=[4, -1]), "exact")
case("flatten", _x(lambda r: S(r, 2, 3, 4, 5), start_axis=1, stop_axis=2),
     "exact")
case("transpose", _x(lambda r: S(r, 2, 3, 4), perm=[2, 0, 1]), "exact")
case("moveaxis", lambda r: ([S(r, 2, 3, 4), 0, 2], {}), "exact")
case("swapaxes", lambda r: ([S(r, 2, 3, 4), 0, 2], {}), "exact")
case("squeeze", _x(lambda r: S(r, 2, 1, 3, 1), axis=[1, 3]), "exact")
case("unsqueeze", _x(lambda r: S(r, 2, 3), axis=[0, 3]), "exact")
case("concat", lambda r: ([[S(r, 2, 3), S(r, 2, 2)]], {"axis": 1}), "exact")
case("stack", lambda r: ([[S(r, 2, 3), S(r, 2, 3)]], {"axis": 1}), "exact")
case("split", lambda r: ([S(r, 7, 3), [2, -1, 3]], {"axis": 0}), "exact")
case("chunk", lambda r: ([S(r, 3, 6), 3], {"axis": 1}), "exact")
case("unbind", _x(lambda r: S(r, 2, 3), axis=1), "exact")
case("unstack", _x(lambda r: S(r, 3, 2), axis=0), "exact")
case("tile", lambda r: ([S(r, 2, 3), [2, 1, 2]], {}), "exact")
case("repeat_interleave", _x(lambda r: S(r, 2, 3), repeats=2, axis=1),
     "exact")
case("expand", _x(lambda r: S(r, 3, 1), shape=[2, -1, 4]), "exact")
case("expand_as", _xy(lambda r: S(r, 3, 1), lambda r: S(r, 2, 3, 4)),
     "exact")
case("broadcast_to", _x(lambda r: S(r, 1, 3), shape=[4, 3]), "exact")
case("broadcast_tensors", lambda r: ([[S(r, 3, 1), S(r, 1, 4)]], {}),
     "exact")
case("flip", _x(lambda r: S(r, 2, 3, 4), axis=[0, 2]), "exact")
case("roll", _x(lambda r: S(r, 3, 4), shifts=2), "exact")
case("rot90", _x(lambda r: S(r, 3, 4), k=3, axes=[0, 1]), "exact")
case("slice_", _x(lambda r: S(r, 4, 5), axes=[0, 1], starts=[1, -3],
                  ends=[3, 10]), "exact")
case("strided_slice", _x(lambda r: S(r, 6, 5), axes=[0, 1], starts=[5, 0],
                         ends=[0, 5], strides=[-2, 2]), "exact")
case("gather", lambda r: ([S(r, 5, 3), I(r, 0, 5, 4)], {"axis": 0}),
     "exact")
case("gather_nd", lambda r: ([S(r, 4, 5, 3), I(r, 0, 4, 6, 2)], {}),
     "exact")
case("take_along_axis", lambda r: ([S(r, 3, 5), I(r, 0, 5, 3, 2)],
                                   {"axis": 1}), "exact")
case("put_along_axis", lambda r: ([S(r, 3, 5),
                                   np.int32([[0, 3], [1, 2], [4, 0]]),
                                   S(r, 3, 2)], {"axis": 1}), "exact")
case("put_along_axis[add]", lambda r: ([S(r, 3, 5),
                                        np.int32([[0, 0], [1, 2], [4, 4]]),
                                        S(r, 3, 2)],
                                       {"axis": 1, "reduce": "add"}),
     "f32", fn="put_along_axis")
case("scatter", lambda r: ([S(r, 5, 3), np.int32([3, 0, 4]), S(r, 3, 3)],
                           {}), "exact")
case("scatter[add]", lambda r: ([S(r, 5, 3), np.int32([3, 0, 3]),
                                 S(r, 3, 3)], {"overwrite": False}), "f32",
     fn="scatter")
case("scatter_nd_add", lambda r: ([S(r, 4, 3), np.int32([[1], [3], [1]]),
                                   S(r, 3, 3)], {}), "f32")
case("scatter_nd", lambda r: ([np.int32([[1, 0], [2, 2], [1, 0]]), S(r, 3),
                               [3, 3]], {}), "f32")
case("index_select", lambda r: ([S(r, 3, 5), I(r, 0, 5, 4)], {"axis": 1}),
     "exact")
case("index_sample", lambda r: ([S(r, 3, 5), I(r, 0, 5, 3, 2)], {}),
     "exact")
case("masked_select", _xy(s34, lambda r: B(r, 3, 4)), "exact")
case("masked_fill", lambda r: ([S(r, 3, 4), B(r, 3, 4), 2.5], {}), "exact")
case("index_put", lambda r: ([S(r, 4, 3), (np.int32([0, 2]),
                                           np.int32([1, 1])),
                              np.float32([5.0, 6.0])], {}), "exact")
case("pad", _x(lambda r: S(r, 1, 2, 3, 4), pad=[1, 2, 0, 1], value=0.5),
     "exact")
case("pad[reflect]", _x(lambda r: S(r, 1, 2, 4, 5), pad=[2, 1, 1, 3],
                        mode="reflect"), "exact", fn="pad")
case("pad[replicate_nhwc]", _x(lambda r: S(r, 1, 4, 5, 2), pad=[2, 1, 1, 3],
                               mode="replicate", data_format="NHWC"),
     "exact", fn="pad")
case("pad[circular]", _x(lambda r: S(r, 1, 2, 5), pad=[2, 3],
                         mode="circular", data_format="NCL"), "exact",
     fn="pad")
case("unique", _x(lambda r: I(r, 0, 6, 3, 4), return_index=True,
                  return_inverse=True, return_counts=True), "exact",
     grad=False)
case("nonzero", _x(lambda r: I(r, 0, 2, 3, 4)), "exact", grad=False)
case("nonzero[tuple]", _x(lambda r: I(r, 0, 2, 3, 4), as_tuple=True),
     "exact", grad=False, fn="nonzero")
case("sort", _x(lambda r: S(r, 3, 5), axis=1, descending=True), "exact")
case("argsort", _x(lambda r: I(r, 0, 3, 3, 5), axis=1, descending=True),
     "exact", grad=False)
case("topk", lambda r: ([S(r, 3, 6), 3], {"axis": 0}), "exact")
case("topk[smallest]", lambda r: ([S(r, 3, 6), 2], {"largest": False}),
     "exact", fn="topk")
case("searchsorted", _xy(lambda r: np.sort(S(r, 8)), lambda r: S(r, 3, 2)),
     "exact", grad=False)
case("bincount", _x(lambda r: I(r, 0, 6, 10), minlength=8), "exact",
     grad=False)
case("bincount[weights]", lambda r: ([I(r, 0, 6, 10), U(r, 0, 1, 10)],
                                     {}), "f32",
     grad=False, fn="bincount")
case("one_hot", _x(lambda r: I(r, 0, 5, 3, 2), num_classes=5), "exact",
     grad=False)
case("as_real", lambda r: ([None], {}), "exact", grad=False, complex_in=True)
case("as_complex", _x(lambda r: S(r, 3, 2)), "exact", grad=False)
case("shard_index", lambda r: ([I(r, 0, 20, 6, 1), 20, 2, 1], {}), "exact",
     grad=False)

# ---- linalg ---------------------------------------------------------------
case("matmul", lambda r: ([S(r, 2, 3, 4), S(r, 2, 5, 4)],
                          {"transpose_y": True}), "trans")
case("mm", _xy(s23, s34), "trans")
case("bmm", _xy(lambda r: S(r, 2, 3, 4), lambda r: S(r, 2, 4, 2)), "trans")
case("dot", _xy(s34, s34), "trans")
case("mv", _xy(s34, lambda r: S(r, 4)), "trans")
case("einsum", lambda r: (["bij,bjk->bik", S(r, 2, 3, 4), S(r, 2, 4, 2)],
                          {}), "trans")
case("norm", _x(s34, p="fro", axis=None), "trans")
case("norm[p3]", _x(s34, p=3, axis=1, keepdim=True), "trans", fn="norm")
case("norm[inf]", _x(s34, p=float("inf"), axis=0), "exact", fn="norm")
case("norm[fro_axes]", _x(lambda r: S(r, 2, 3, 4), p="fro", axis=[1, 2]),
     "trans", fn="norm")
case("cross", _xy(lambda r: S(r, 4, 3), lambda r: S(r, 4, 3)), "trans")
case("t", _x(s23), "exact")
case("cholesky", _x(lambda r: spd(r, 4)), "trans")
case("inverse", _x(lambda r: well(r, 4)), "trans")
case("inv", _x(lambda r: well(r, 3)), "trans")
case("pinv", _x(lambda r: S(r, 4, 3)), "trans")
case("det", _x(lambda r: well(r, 4)), "trans")
case("slogdet", _x(lambda r: well(r, 4)), "trans")
case("matrix_power", _x(lambda r: S(r, 3, 3) * 0.5, n=3), "trans")
case("matrix_rank", _x(lambda r: S(r, 4, 2) @ S(r, 2, 5)), "exact",
     grad=False)
case("qr", _x(lambda r: S(r, 5, 3)), "trans")
# LAPACK may give either sign of a singular vector pair: compared up to
# sign (``canonical``), without gradients
case("svd", _x(lambda r: S(r, 4, 3)), "trans", grad=False, canonical=True)
case("eigh", _x(lambda r: spd(r, 4)), "trans")
case("eig", _x(lambda r: spd(r, 3)), "trans", grad=False)
case("eigvals", _x(lambda r: spd(r, 3)), "trans", grad=False)
case("eigvalsh", _x(lambda r: spd(r, 4)), "trans")
case("solve", _xy(lambda r: well(r, 4), lambda r: S(r, 4, 2)), "trans")
case("triangular_solve", _xy(lambda r: np.triu(well(r, 4)),
                             lambda r: S(r, 4, 2)), "trans")
case("triangular_solve[lower_t]",
     lambda r: ([np.tril(well(r, 4)), S(r, 4, 2)],
                {"upper": False, "transpose": True}), "trans",
     fn="triangular_solve")
case("cholesky_solve", lambda r: ([S(r, 4, 2),
                                   np.linalg.cholesky(spd(r, 4))], {}),
     "trans")
case("lstsq", _xy(lambda r: S(r, 6, 3), lambda r: S(r, 6, 2)), "trans",
     grad=False)
case("lu", _x(lambda r: well(r, 4)), "trans", grad=False)
case("lu_unpack", lambda r: ([None], {}), "trans", grad=False, from_lu=True)
case("cond", _x(lambda r: well(r, 4)), "trans")
case("corrcoef", _x(lambda r: S(r, 3, 6)), "trans")
case("cov", _x(lambda r: S(r, 6, 3), rowvar=False), "trans")
case("histogram", _x(lambda r: S(r, 50), bins=6), "exact", grad=False)
case("histogram[range]", _x(lambda r: S(r, 50), bins=4, min=-1, max=1),
     "exact", grad=False, fn="histogram")
case("matrix_transpose", _x(lambda r: S(r, 2, 3, 4)), "exact")

# ---- misc -----------------------------------------------------------------
case("cast", _x(lambda r: S(r, 3, 4) * 5, dtype="int64"), "exact",
     grad=False)
case("cast[bf16]", _x(lambda r: S(r, 3, 4), dtype="bfloat16"), "exact",
     grad=False, fn="cast")
case("add_n", lambda r: ([[S(r, 2, 3), S(r, 2, 3), S(r, 2, 3)]], {}))
case("logit", _x(lambda r: U(r, 0.05, 0.95, 3, 4), eps=0.1), "trans")
case("dist", _xy(s34, s34, p=3), "trans")
case("dist[inf]", _xy(s34, s34, p=float("inf")), "exact", fn="dist")
case("nanquantile", _x(lambda r: with_nans(r, 3, 5), q=0.3, axis=1),
     "trans")
case("tensordot", lambda r: ([S(r, 2, 3, 4), S(r, 3, 4, 5)],
                             {"axes": [[1, 2], [0, 1]]}), "trans")
case("crop", _x(lambda r: S(r, 4, 5), shape=[2, -1], offsets=[1, 0]),
     "exact")
case("reverse", _x(lambda r: S(r, 3, 4), axis=1), "exact")
case("complex", _xy(s23, s23), "exact", grad=False)
case("floor_mod", _xy(lambda r: I(r, -20, 20, 3), lambda r: I(r, 1, 5, 3)),
     "exact", grad=False)
for name in ("is_tensor", "is_complex", "is_floating_point", "is_integer",
             "shape", "rank", "numel", "is_empty", "tolist"):
    case(name, _x(lambda r: I(r, 0, 5, 2, 3)), "exact", grad=False)
case("broadcast_shape", lambda r: ([[2, 1, 4], [3, 1]], {}), "exact",
     grad=False)
case("unique_consecutive", _x(lambda r: np.int32([1, 1, 2, 2, 2, 3, 1, 1]),
                              return_inverse=True, return_counts=True),
     "exact", grad=False)
case("unique_consecutive[axis]",
     _x(lambda r: np.int32([[1, 1, 2], [1, 1, 2], [0, 1, 2]]), axis=0,
        return_counts=True), "exact", grad=False, fn="unique_consecutive")

# ---- creation (deterministic) ---------------------------------------------
case("full", lambda r: ([[2, 3], 1.5], {}), "exact", grad=False)
case("full[bool]", lambda r: ([[2], True], {"dtype": "bool"}), "exact",
     grad=False, fn="full")
case("zeros", lambda r: ([[2, 3]], {"dtype": "int64"}), "exact", grad=False)
case("ones", lambda r: ([[3]], {}), "exact", grad=False)
case("empty", lambda r: ([[2]], {"dtype": "float32"}), "exact", grad=False)
case("full_like", lambda r: ([S(r, 2, 3), 7], {"dtype": "int32"}), "exact",
     grad=False)
case("zeros_like", _x(s23), "exact", grad=False)
case("ones_like", _x(lambda r: I(r, 0, 3, 2, 3)), "exact", grad=False)
case("empty_like", _x(s23), "exact", grad=False)
case("arange", lambda r: ([2, 11, 3], {}), "exact", grad=False)
case("arange[float]", lambda r: ([0.0, 1.0, 0.25], {}), "exact", grad=False,
     fn="arange")
case("linspace", lambda r: ([-1.0, 2.0, 7], {}), "f32", grad=False)
case("logspace", lambda r: ([0.0, 2.0, 5], {"base": 2.0}), "trans",
     grad=False)
case("eye", lambda r: ([3, 4], {}), "exact", grad=False)
case("tril", _x(lambda r: S(r, 4, 4), diagonal=-1), "exact")
case("triu", _x(lambda r: S(r, 3, 4), diagonal=1), "exact")
case("diag", _x(lambda r: S(r, 3), offset=1), "exact")
case("diag[2d]", _x(lambda r: S(r, 3, 4), offset=-1), "exact", fn="diag")
case("diagflat", _x(lambda r: S(r, 2, 2), offset=0), "exact")
# the reference's meshgrid outputs are cut from its tape: no gradients
case("meshgrid", lambda r: ([S(r, 3), S(r, 2)], {}), "exact", grad=False)
case("assign", lambda r: ([S(r, 2, 3)], {}), "exact")
case("assign[ndarray]", lambda r: ([Raw(I(r, 0, 5, 4))], {}), "exact",
     grad=False, fn="assign")
case("clone", _x(s23), "exact")

# ---- fft (the package's ``fft`` module) -----------------------------------
def C(r, *shape):
    return (S(r, *shape) + 1j * S(r, *shape)).astype(np.complex64)


for name, make, grad in (
        ("fft", _x(lambda r: S(r, 4, 6), n=8, axis=-1, norm="ortho"), False),
        ("ifft", _x(lambda r: C(r, 4, 6), axis=0), False),
        ("fft2", _x(lambda r: C(r, 3, 4, 6)), False),
        ("ifft2", _x(lambda r: C(r, 3, 4, 6), norm="forward"), False),
        ("fftn", _x(lambda r: S(r, 3, 4, 5)), False),
        ("ifftn", _x(lambda r: C(r, 3, 4, 5), s=[4, 4], axes=[0, 1]),
         False),
        ("rfft", _x(lambda r: S(r, 4, 6), n=10), False),
        ("irfft", _x(lambda r: C(r, 4, 5), n=8), False),
        ("rfft2", _x(lambda r: S(r, 3, 4, 6)), False),
        ("irfft2", _x(lambda r: C(r, 3, 4, 4)), False),
        ("rfftn", _x(lambda r: S(r, 3, 4, 6)), False),
        ("irfftn", _x(lambda r: C(r, 3, 4, 4)), False),
        ("hfft", _x(lambda r: C(r, 4, 5), n=8), False),
        ("ihfft", _x(lambda r: S(r, 4, 6)), False),
        ("hfft2", _x(lambda r: C(r, 4, 5)), False),
        ("ihfft2", _x(lambda r: S(r, 4, 6)), False),
        ("hfftn", _x(lambda r: C(r, 3, 4, 5)), False),
        ("ihfftn", _x(lambda r: S(r, 3, 4, 6)), False),
        ("fftshift", _x(lambda r: S(r, 4, 5)), True),
        ("ifftshift", _x(lambda r: S(r, 4, 5), axes=[1]), True),
        ("fftfreq", lambda r: ([7], {"d": 0.5}), False),
        ("rfftfreq", lambda r: ([8], {"d": 2.0}), False)):
    case(f"fft.{name}", make, "exact" if "shift" in name else "trans",
         grad=grad)

# the random ops: held by seed, shape, dtype, range and moments
# (test_torch_ops.py), not by values
RANDOM = ("rand", "uniform", "randn", "normal", "randint", "randperm",
          "bernoulli", "multinomial", "poisson", "standard_normal",
          "randint_like")
# the in-place variants and the TensorArray, held in test_torch_tensor.py
# and test_torch_ops.py by their own tests
OWN_TESTS = ("reshape_", "squeeze_", "unsqueeze_", "flatten_", "scatter_",
             "tanh_", "exp_", "sqrt_", "rsqrt_", "clip_", "ceil_", "floor_",
             "round_", "reciprocal_", "subtract_", "add_", "scale_", "zero_",
             "fill_", "increment", "create_parameter", "create_array",
             "array_write", "array_read", "array_length")


def fn_name(cid):
    c = CASES[cid]
    return c.fn or cid


def op_fn(ops, cid):
    """The function of case ``cid``: in ``ops`` (a package's ``ops``
    module), or in that package's ``fft`` module for an "fft." case."""
    name = fn_name(cid)
    if name.startswith("fft."):
        import importlib
        return getattr(importlib.import_module(
            ops.__name__.split(".")[0] + ".fft"), name[4:])
    return getattr(ops, name)


def make_inputs(cid):
    """(args, kwargs) of a case, with ``complex_in`` / ``from_lu`` inputs
    built."""
    c = CASES[cid]
    r = rng_for(cid)
    args, kw = c.make(r)
    if c.extra.get("complex_in"):
        args = [(S(r, 2, 3) + 1j * S(r, 2, 3)).astype(np.complex64)]
    if c.extra.get("from_lu"):
        args = [("lu", well(r, 4))]
    return args, kw


def wants_grad(cid):
    """A case's gradients are compared when it says so and it has a float
    input."""
    args, kw = make_inputs(cid)
    flat = _leaves(list(args) + list(kw.values()))
    return CASES[cid].grad and any(isinstance(a, np.ndarray) and
                                   a.dtype == np.float32 for a in flat)


def canonical(outs):
    """Each singular-vector matrix of an ``svd`` with the sign of each
    vector fixed (its largest-magnitude entry positive): (U, S, Vh)."""
    (u, ut), (s, st), (vh, vt) = outs
    sign = np.sign(u[np.abs(u).argmax(0), np.arange(u.shape[1])])
    return [(u * sign, ut), (s, st), (vh * sign[:, None], vt)]


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def outputs_numpy(out, to_numpy):
    """The leaves of ``out`` as ndarrays, each with whether it was a
    tensor (``to_numpy`` gives a tensor's ndarray, or None for a
    non-tensor)."""
    res = []
    for o in _leaves(out):
        a = to_numpy(o)
        res.append((a, True) if a is not None else (np.asarray(o), False))
    return res


def cotangents(cid, outs):
    """A fixed random cotangent for each float output (None otherwise)."""
    r = rng_for(cid + "/cotangent")
    return [r.standard_normal(a.shape).astype(np.float32)
            if t and a.dtype.kind == "f" else None for a, t in outs]


def run_port(ops, cid, device, grad):
    """Run case ``cid`` through the port's ``ops`` on ``device``: (outputs
    as ``outputs_numpy`` gives them, the float inputs' gradients as
    ndarrays, or None without ``grad``)."""
    import torch
    args, kw = make_inputs(cid)
    leaves = []

    def conv(v):
        if isinstance(v, Raw):
            return v.a
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v.copy()).to(device)
            if grad and v.dtype == np.float32:
                t.requires_grad_(True)
                leaves.append(t)
            return t
        if isinstance(v, (list, tuple)) and not (v and isinstance(v[0],
                                                                  str)):
            return type(v)(conv(x) for x in v)
        return v
    fn = op_fn(ops, cid)
    if args and isinstance(args[0], tuple) and args[0] and \
            args[0][0] == "lu":
        packed, piv = ops.lu(torch.from_numpy(args[0][1]).to(device))
        out = fn(packed, piv)
    else:
        out = fn(*[conv(a) for a in args],
                 **{k: conv(v) for k, v in kw.items()})

    def to_np(o):
        if isinstance(o, torch.Tensor):
            o = o.detach().cpu()
            return (o.float() if o.dtype == torch.bfloat16 else o).numpy()
        return None
    outs = outputs_numpy(out, to_np)
    if not grad:
        return outs, None
    if not leaves:
        return outs, []
    tens = [o for o in _leaves(out) if isinstance(o, torch.Tensor)]
    cots = cotangents(cid, outs)
    loss = sum((t * torch.from_numpy(c).to(t.device)).sum()
               for t, c in zip(tens, [c for c, (_, isT) in zip(cots, outs)
                                      if isT]) if c is not None)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return outs, [np.zeros(tuple(x.shape), np.float32) if g is None
                  else g.detach().cpu().numpy() for g, x in zip(gs, leaves)]


def compare(cid, got, want, tol=None):
    """The worst |got - want| / (atol + rtol |want|) over the outputs
    (<= 1 passes); raises AssertionError on a shape, dtype, count or
    non-finite mismatch."""
    atol, rtol = TOLS[tol or CASES[cid].tol]
    if CASES[cid].extra.get("canonical"):
        got, want = canonical(got), canonical(want)
    assert len(got) == len(want), (cid, len(got), len(want))
    worst = 0.0
    for (g, gt), (w, wt) in zip(got, want):
        assert g.shape == w.shape, (cid, g.shape, w.shape)
        if gt and wt:
            assert g.dtype == w.dtype, (cid, g.dtype, w.dtype)
        if g.dtype.kind in "biu" or w.dtype.kind in "biu" or \
                (atol == 0 and rtol == 0):
            assert np.array_equal(g, w, equal_nan=True), (cid, g, w)
            continue
        gf, wf = g.astype(np.complex128), w.astype(np.complex128)
        same = (np.isnan(gf) & np.isnan(wf)) | (gf == wf)
        err = np.where(same, 0.0, np.abs(gf - wf)) / (atol + rtol * np.abs(wf))
        worst = max(worst, float(np.max(err, initial=0.0)))
    assert worst <= 1.0, (cid, worst)
    return worst
