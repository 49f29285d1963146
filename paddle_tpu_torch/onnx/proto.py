"""Minimal protobuf wire-format writer + ONNX message builders of the
PyTorch port.

The port's own copy of ``paddle_tpu/onnx/proto.py`` (numpy only): ONNX
files are plain protobuf and the message schema (onnx/onnx.proto) is
public, so the exporter emits the wire format directly, with no ``onnx``
package. Field numbers follow onnx.proto (IR version 8 / opset 17 era).
A generic reader (``decode_message``) parses any protobuf back into
{field_number: [values]} for tests and tooling. A bfloat16 tensor is
written from its bits (``tensor_proto`` takes a numpy array, or the
port's bfloat16 record: the bits as uint16 and ``bf16=True``).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

import numpy as np

# -- wire primitives --------------------------------------------------------

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # two's complement, 10-byte encoding
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def emit_varint(field: int, value: int) -> bytes:
    return _key(field, _WT_VARINT) + _varint(int(value))


def emit_bytes(field: int, blob: bytes) -> bytes:
    return _key(field, _WT_LEN) + _varint(len(blob)) + blob


def emit_string(field: int, s: str) -> bytes:
    return emit_bytes(field, s.encode("utf-8"))


def emit_float(field: int, v: float) -> bytes:
    return _key(field, _WT_I32) + struct.pack("<f", float(v))


# -- generic decoder (for tests) -------------------------------------------

Value = Union[int, bytes]


def decode_message(blob: bytes) -> Dict[int, List[Value]]:
    """Parse one protobuf message into {field: [raw values]}; length-
    delimited fields come back as bytes (decode nested messages by calling
    again)."""
    out: Dict[int, List[Value]] = {}
    i = 0
    n = len(blob)
    while i < n:
        tag, i = _read_varint(blob, i)
        field, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            v, i = _read_varint(blob, i)
        elif wt == _WT_LEN:
            ln, i = _read_varint(blob, i)
            v = blob[i:i + ln]
            i += ln
        elif wt == _WT_I32:
            v = struct.unpack("<f", blob[i:i + 4])[0]
            i += 4
        elif wt == _WT_I64:
            v = struct.unpack("<d", blob[i:i + 8])[0]
            i += 8
        else:
            raise ValueError(f"bad wire type {wt}")
        out.setdefault(field, []).append(v)
    return out


def _read_varint(blob: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    v = 0
    while True:
        b = blob[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


# -- ONNX schema constants --------------------------------------------------

class DataType:
    FLOAT = 1
    UINT8 = 2
    INT8 = 3
    INT32 = 6
    INT64 = 7
    BOOL = 9
    FLOAT16 = 10
    DOUBLE = 11
    BFLOAT16 = 16


_NP_TO_ONNX = {
    np.dtype(np.float32): DataType.FLOAT,
    np.dtype(np.float64): DataType.DOUBLE,
    np.dtype(np.float16): DataType.FLOAT16,
    np.dtype(np.int32): DataType.INT32,
    np.dtype(np.int64): DataType.INT64,
    np.dtype(np.int8): DataType.INT8,
    np.dtype(np.uint8): DataType.UINT8,
    np.dtype(bool): DataType.BOOL,
}


def onnx_dtype(np_dtype) -> int:
    if str(np_dtype) == "bfloat16":
        return DataType.BFLOAT16
    d = np.dtype(np_dtype)
    if d.name == "bfloat16":
        return DataType.BFLOAT16
    try:
        return _NP_TO_ONNX[d]
    except KeyError:
        raise ValueError(f"dtype {d} has no ONNX mapping") from None


class AttrType:
    FLOAT = 1
    INT = 2
    STRING = 3
    TENSOR = 4
    FLOATS = 6
    INTS = 7
    STRINGS = 8


# -- ONNX message builders --------------------------------------------------

def tensor_proto(name: str, arr: np.ndarray, bf16: bool = False) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9. ``bf16``:
    ``arr`` holds bfloat16 bits as uint16."""
    arr = np.ascontiguousarray(arr)
    msg = b""
    for d in arr.shape:
        msg += emit_varint(1, d)
    msg += emit_varint(2, DataType.BFLOAT16 if bf16
                       else onnx_dtype(arr.dtype))
    msg += emit_string(8, name)
    if arr.dtype.name == "bfloat16":
        raw = arr.view(np.uint16).tobytes()
    else:
        raw = arr.tobytes()
    msg += emit_bytes(9, raw)
    return msg


def attribute_proto(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    type=20."""
    msg = emit_string(1, name)
    if isinstance(value, bool):
        msg += emit_varint(3, int(value)) + emit_varint(20, AttrType.INT)
    elif isinstance(value, int):
        msg += emit_varint(3, value) + emit_varint(20, AttrType.INT)
    elif isinstance(value, float):
        msg += emit_float(2, value) + emit_varint(20, AttrType.FLOAT)
    elif isinstance(value, str):
        msg += emit_string(4, value) + emit_varint(20, AttrType.STRING)
    elif isinstance(value, np.ndarray):
        msg += emit_bytes(5, tensor_proto(name + "_t", value))
        msg += emit_varint(20, AttrType.TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, bool, np.integer)) for v in value):
            for v in value:
                msg += emit_varint(8, int(v))
            msg += emit_varint(20, AttrType.INTS)
        elif all(isinstance(v, (int, float, np.floating)) for v in value):
            for v in value:
                msg += emit_float(7, float(v))
            msg += emit_varint(20, AttrType.FLOATS)
        else:
            raise ValueError(f"unsupported attr list {value!r}")
    else:
        raise ValueError(f"unsupported attr {value!r}")
    return msg


def node_proto(op_type: str, inputs, outputs, name: str = "",
               attrs: dict | None = None) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    msg = b""
    for s in inputs:
        msg += emit_string(1, s)
    for s in outputs:
        msg += emit_string(2, s)
    if name:
        msg += emit_string(3, name)
    msg += emit_string(4, op_type)
    for k, v in (attrs or {}).items():
        msg += emit_bytes(5, attribute_proto(k, v))
    return msg


def _tensor_shape_proto(shape) -> bytes:
    """TensorShapeProto: dim=1 (Dimension: dim_value=1, dim_param=2)."""
    msg = b""
    for i, d in enumerate(shape):
        if d is None or int(d) < 0:
            dim = emit_string(2, f"dyn_{i}")
        else:
            dim = emit_varint(1, int(d))
        msg += emit_bytes(1, dim)
    return msg


def value_info_proto(name: str, shape, np_dtype) -> bytes:
    """ValueInfoProto: name=1, type=2; TypeProto.tensor_type=1
    (elem_type=1, shape=2)."""
    tensor_type = emit_varint(1, onnx_dtype(np_dtype))
    tensor_type += emit_bytes(2, _tensor_shape_proto(shape))
    type_proto = emit_bytes(1, tensor_type)
    return emit_string(1, name) + emit_bytes(2, type_proto)


def graph_proto(name: str, nodes, inputs, outputs, initializers) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    msg = b""
    for n in nodes:
        msg += emit_bytes(1, n)
    msg += emit_string(2, name)
    for t in initializers:
        msg += emit_bytes(5, t)
    for v in inputs:
        msg += emit_bytes(11, v)
    for v in outputs:
        msg += emit_bytes(12, v)
    return msg


def model_proto(graph: bytes, opset: int = 17,
                producer: str = "paddle-tpu") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8
    (OperatorSetIdProto: domain=1, version=2)."""
    msg = emit_varint(1, 8)  # IR version 8
    msg += emit_string(2, producer)
    msg += emit_bytes(7, graph)
    msg += emit_bytes(8, emit_string(1, "") + emit_varint(2, opset))
    return msg
