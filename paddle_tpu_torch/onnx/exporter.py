"""Static Program -> ONNX graph converter of the PyTorch port.

Counterpart of ``paddle_tpu/onnx/exporter.py``: the captured static DAG
(``static/graph.py``) is walked from the fetch variables and each op is
converted by its name through ``OP_CONVERTERS`` (the reference's 37);
parameters and tensor constants become initializers, bit for bit
(bfloat16 from its bits). The reference reads some attributes from the
free variables of its ``jnp`` lowering closures (``closure_attrs``,
``:28-34``); the port's ops take their attributes as the node's keyword
arguments (``stride=``, ``epsilon=``, ...), and an op captured from a
torch method (``x.permute(...)``, ``torch.cat``) as its positional ones,
so each converter reads them there. ``bound_attrs`` binds the node's
arguments against ``OP_REGISTRY[name].raw_fn``'s signature, as the
reference's does (``:36-53``).
"""
from __future__ import annotations

import inspect
from typing import Dict, List

import numpy as np
import torch

from ..static.graph import OpNode, StaticVar, _leaves
from . import proto


class UnsupportedOp(ValueError):
    pass


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def bound_attrs(node: OpNode) -> dict:
    """The node's keyword arguments, and its non-tensor positional ones
    named by the registered op's signature (matmul's transpose flags, a
    reduction's axis, ...)."""
    from ..ops.dispatch import OP_REGISTRY
    api = OP_REGISTRY.get(node.name)
    out = dict(node.kwargs)
    if api is None or not hasattr(api, "raw_fn"):
        return out
    try:
        ba = inspect.signature(api.raw_fn).bind_partial(*node.args)
    except (TypeError, ValueError):
        return out
    for k, v in ba.arguments.items():
        if not isinstance(v, torch.Tensor) and k not in ("args", "kwargs"):
            out.setdefault(k, v)
    return out


class ExportContext:
    def __init__(self, graph_name="main"):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.inputs: List[bytes] = []
        self.outputs: List[bytes] = []
        self.opset = 13
        self._names: Dict[int, str] = {}
        self._const_count = 0
        self.graph_name = graph_name

    def need_opset(self, v: int):
        self.opset = max(self.opset, v)

    # -- naming / constants ----------------------------------------------
    def name_of(self, var) -> str:
        if isinstance(var, StaticVar):
            return var.name
        key = id(var)
        if key not in self._names:
            nm = f"const_{self._const_count}"
            self._const_count += 1
            self._names[key] = nm
            self.initializers.append(_tensor_proto(nm, var))
        return self._names[key]

    def add_const(self, arr: np.ndarray, hint="c") -> str:
        nm = f"{hint}_{self._const_count}"
        self._const_count += 1
        self.initializers.append(proto.tensor_proto(nm, np.asarray(arr)))
        return nm

    def emit(self, op_type, inputs, outputs, attrs=None, name=""):
        self.nodes.append(proto.node_proto(
            op_type, inputs, outputs, name=name, attrs=attrs))


def _tensor_proto(name, t) -> bytes:
    """An initializer from a tensor (its bits; bfloat16 as uint16) or an
    array."""
    if not isinstance(t, torch.Tensor):
        return proto.tensor_proto(name, np.asarray(t))
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return proto.tensor_proto(
            name, t.view(torch.int16).numpy().view(np.uint16), bf16=True)
    return proto.tensor_proto(name, t.numpy())


def _tensors(node):
    return [a for a in _leaves([node.args], []) if isinstance(a, torch.Tensor)]


def _ndim(v) -> int:
    return len(v._shape) if isinstance(v, StaticVar) else v.dim()


# ---------------------------------------------------------------------------
# converters: fn(ctx, node, ins, outs, attrs)
#   ins  = ONNX names of the node's tensor inputs, in argument order
#   outs = ONNX names of the node's outputs
# ---------------------------------------------------------------------------
def _simple(onnx_op, min_opset=13):
    def conv(ctx, node, ins, outs, attrs):
        ctx.need_opset(min_opset)
        ctx.emit(onnx_op, ins, outs)
    return conv


def _swap_last2_perm(var):
    perm = list(range(_ndim(var)))
    if len(perm) >= 2:
        perm[-1], perm[-2] = perm[-2], perm[-1]
    return perm


def _conv_matmul(ctx, node, ins, outs, attrs):
    x, y = ins
    tensors = _tensors(node)
    if attrs.get("transpose_x"):
        x2 = outs[0] + "_xT"
        ctx.emit("Transpose", [x], [x2],
                 {"perm": _swap_last2_perm(tensors[0])})
        x = x2
    if attrs.get("transpose_y"):
        y2 = outs[0] + "_yT"
        ctx.emit("Transpose", [y], [y2],
                 {"perm": _swap_last2_perm(tensors[1])})
        y = y2
    ctx.emit("MatMul", [x, y], outs)


def _conv_linear(ctx, node, ins, outs, attrs):
    if len(ins) == 3:
        mm = outs[0] + "_mm"
        ctx.emit("MatMul", ins[:2], [mm])
        ctx.emit("Add", [mm, ins[2]], outs)
    else:
        ctx.emit("MatMul", ins, outs)


def _conv_softmax(ctx, node, ins, outs, attrs):
    axis = attrs.get("axis", attrs.get("dim", -1))
    ctx.emit("Softmax", ins, outs, {"axis": int(axis)})


def _conv_gelu(ctx, node, ins, outs, attrs):
    ctx.need_opset(20)
    approx = attrs.get("approximate")
    ctx.emit("Gelu", ins, outs,
             {"approximate": "tanh" if approx in (True, "tanh") else "none"})


def _conv_reshape(ctx, node, ins, outs, attrs):
    shape = [int(d) for d in node.out_vars[0]._shape]
    shp = ctx.add_const(np.asarray(shape, np.int64), "shape")
    ctx.emit("Reshape", [ins[0], shp], outs)


_conv_flatten = _conv_reshape  # static shapes: both are a Reshape


def _perm(node, attrs):
    if "perm" in attrs:                 # the port's transpose(x, perm)
        return attrs["perm"]
    rest = [a for a in node.args[1:]]   # torch's permute(x, *dims)
    if "dims" in node.kwargs:
        rest = [node.kwargs["dims"]]
    if len(rest) == 1 and isinstance(rest[0], (list, tuple)):
        rest = list(rest[0])
    return rest or None


def _conv_transpose(ctx, node, ins, outs, attrs):
    perm = _perm(node, attrs)
    a = {} if perm is None else {"perm": [int(p) for p in perm]}
    ctx.emit("Transpose", ins, outs, a)


def _conv_concat(ctx, node, ins, outs, attrs):
    axis = attrs.get("axis", attrs.get("dim"))
    if axis is None:                    # torch.cat(tensors, dim)
        axis = node.args[1] if len(node.args) > 1 else 0
    ctx.emit("Concat", ins, outs, {"axis": int(axis)})


def _pads_of(padding, n):
    if isinstance(padding, str):
        raise UnsupportedOp(f"string padding {padding!r} in ONNX export")
    if isinstance(padding, int):
        per = [padding] * n
    else:
        per = [int(p) for p in padding]
        if len(per) == 1:
            per = per * n
    return per + per  # onnx wants begins then ends


def _tuplize(v, n):
    if isinstance(v, int):
        return [v] * n
    return [int(t) for t in v]


def _conv_conv2d(ctx, node, ins, outs, attrs):
    if attrs.get("data_format", "NCHW") != "NCHW":
        raise UnsupportedOp("ONNX Conv requires NCHW")
    a = {"strides": _tuplize(attrs.get("stride", 1), 2),
         "pads": _pads_of(attrs.get("padding", 0), 2),
         "dilations": _tuplize(attrs.get("dilation", 1), 2),
         "group": int(attrs.get("groups", 1))}
    ctx.emit("Conv", ins, outs, a)


def _conv_pool2d(onnx_op):
    def conv(ctx, node, ins, outs, attrs):
        if attrs.get("data_format", "NCHW") != "NCHW":
            raise UnsupportedOp(f"ONNX {onnx_op} requires NCHW")
        if attrs.get("return_mask"):
            raise UnsupportedOp("return_mask pooling in ONNX export")
        ks = _tuplize(attrs["kernel_size"], 2)
        stride = attrs.get("stride")
        a = {"kernel_shape": ks,
             "strides": _tuplize(stride if stride is not None
                                 else attrs["kernel_size"], 2),
             "pads": _pads_of(attrs.get("padding", 0), 2)}
        if attrs.get("ceil_mode"):
            a["ceil_mode"] = 1
        ctx.emit(onnx_op, ins, outs, a)
    return conv


def _conv_batch_norm(ctx, node, ins, outs, attrs):
    # the port's batch_norm(x, mean, var, weight, bias): a missing weight
    # or bias is None there, and not among ``ins``
    x, mean, var = ins[0], ins[1], ins[2]
    rest = ins[3:]
    c = int(node.out_vars[0]._shape[1])
    i = 0
    if node.args[3] is not None:
        scale = rest[i]
        i += 1
    else:
        scale = ctx.add_const(np.ones(c, np.float32), "bn_scale")
    b = rest[i] if node.args[4] is not None else ctx.add_const(
        np.zeros(c, np.float32), "bn_bias")
    eps = float(attrs.get("epsilon", 1e-5))
    ctx.emit("BatchNormalization", [x, scale, b, mean, var], outs,
             {"epsilon": eps})


def _conv_layer_norm(ctx, node, ins, outs, attrs):
    ctx.need_opset(17)
    a = {"axis": _ndim(node.args[0]) - int(attrs.get("n", 1)),
         "epsilon": float(attrs.get("epsilon", 1e-5))}
    if node.args[1] is None or node.args[2] is None:
        raise UnsupportedOp("LayerNormalization export needs weight+bias")
    ctx.emit("LayerNormalization", ins, outs, a)


def _conv_reduce(onnx_op, axes_as_input=False):
    def conv(ctx, node, ins, outs, attrs):
        axis = attrs.get("axis")
        keep = 1 if attrs.get("keepdim") else 0
        axes = None if axis is None else (
            [int(a) for a in axis] if isinstance(axis, (list, tuple))
            else [int(axis)])
        if axes_as_input:  # ReduceSum >= opset 13 takes axes as an input
            inputs = list(ins)
            if axes is not None:
                inputs.append(ctx.add_const(np.asarray(axes, np.int64),
                                            "axes"))
            ctx.emit(onnx_op, inputs, outs, {"keepdims": keep})
        else:
            a = {"keepdims": keep}
            if axes is not None:
                a["axes"] = axes
            ctx.emit(onnx_op, ins, outs, a)
    return conv


def _conv_embedding(ctx, node, ins, outs, attrs):
    # embedding(ids, weight) -> Gather(weight, ids)
    ctx.emit("Gather", [ins[1], ins[0]], outs, {"axis": 0})


OP_CONVERTERS = {
    "matmul": _conv_matmul,
    "mm": _simple("MatMul"),
    "linear": _conv_linear,
    "add": _simple("Add"),
    "subtract": _simple("Sub"),
    "multiply": _simple("Mul"),
    "divide": _simple("Div"),
    "pow": _simple("Pow"),
    "maximum": _simple("Max"),
    "minimum": _simple("Min"),
    "relu": _simple("Relu"),
    "sigmoid": _simple("Sigmoid"),
    "tanh": _simple("Tanh"),
    "exp": _simple("Exp"),
    "log": _simple("Log"),
    "sqrt": _simple("Sqrt"),
    "abs": _simple("Abs"),
    "neg": _simple("Neg"),
    "erf": _simple("Erf"),
    "floor": _simple("Floor"),
    "ceil": _simple("Ceil"),
    "gelu": _conv_gelu,
    "softmax": _conv_softmax,
    "reshape": _conv_reshape,
    "flatten": _conv_flatten,
    "transpose": _conv_transpose,
    "concat": _conv_concat,
    "conv2d": _conv_conv2d,
    "max_pool2d": _conv_pool2d("MaxPool"),
    "avg_pool2d": _conv_pool2d("AveragePool"),
    "batch_norm": _conv_batch_norm,
    "layer_norm": _conv_layer_norm,
    "mean": _conv_reduce("ReduceMean"),
    "sum": _conv_reduce("ReduceSum", axes_as_input=True),
    "max": _conv_reduce("ReduceMax"),
    "min": _conv_reduce("ReduceMin"),
    "embedding": _conv_embedding,
}


def _topo_order(outputs) -> List[OpNode]:
    from ..static.executor import _order
    return _order([v for v in outputs if isinstance(v, StaticVar)])


def program_to_onnx(feed_vars, fetch_vars, graph_name="main") -> bytes:
    """The DAG reaching ``fetch_vars`` as ONNX ModelProto bytes;
    ``feed_vars`` are its inputs (``static.data`` variables)."""
    ctx = ExportContext(graph_name)
    for v in feed_vars:
        ctx.inputs.append(proto.value_info_proto(
            v.name, v._shape, _dtype_name(v.dtype)))
    for node in _topo_order(fetch_vars):
        conv = OP_CONVERTERS.get(node.name)
        if conv is None:
            raise UnsupportedOp(
                f"op '{node.name}' has no ONNX converter "
                f"(supported: {sorted(OP_CONVERTERS)})")
        ins = [ctx.name_of(a) for a in _tensors(node)]
        outs = [ov.name for ov in node.out_vars]
        conv(ctx, node, ins, outs, bound_attrs(node))
    for v in fetch_vars:
        ctx.outputs.append(proto.value_info_proto(
            v.name, v._shape, _dtype_name(v.dtype)))
    graph = proto.graph_proto(ctx.graph_name, ctx.nodes, ctx.inputs,
                              ctx.outputs, ctx.initializers)
    return proto.model_proto(graph, opset=ctx.opset)
