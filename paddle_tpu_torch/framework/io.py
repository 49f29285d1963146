"""``paddle.save`` / ``paddle.load`` of the PyTorch port.

Counterpart of ``paddle_tpu/framework/io.py``, on the reference's disk
form: a pickle (protocol 4) of the object with every tensor replaced by a
record ``{"__tensor__": True, "data": ndarray, "stop_gradient": bool,
"param": bool}``, written to a temporary file in the same directory and
moved onto the path with ``os.replace``, so that a failed write never
leaves a truncated file where a checkpoint was. A card tensor is copied to
the host. The files cross between the packages both ways.

bfloat16: numpy has no bfloat16 of its own (the reference pickles an
``ml_dtypes`` array, which needs ``ml_dtypes`` to load). The port writes a
bfloat16 tensor's record with ``"data"`` its bits as a uint16 array and
``"dtype": "bfloat16"``, so that it loads again, bit for bit, where
``ml_dtypes`` cannot be imported; the reference reads such a record as a
uint16 tensor of those bits. The port reads both forms: a reference file
with ``ml_dtypes`` arrays where ``ml_dtypes`` can be imported.

``load`` makes each tensor on the default device (``cuda`` unless
``set_device`` said otherwise), a ``Parameter`` where ``param`` is set
(trainable unless ``stop_gradient``), and keeps each array's dtype (the
reference's tensors narrow 64-bit types, as JAX does). ``return_numpy``
gives the arrays: a bfloat16 one as an ``ml_dtypes`` array where that
module can be imported, else its values as float32 (exact).
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ..core.dtype import numpy_to_torch
from ..core.place import resolve_device
from ..core.tensor import Parameter


def _record(t: torch.Tensor) -> dict:
    data = t.detach().cpu()
    rec = {"__tensor__": True,
           "stop_gradient": not t.requires_grad,
           "param": isinstance(t, torch.nn.Parameter)}
    if data.dtype == torch.bfloat16:
        rec["data"] = data.view(torch.int16).numpy().view(
            np.uint16).copy()
        rec["dtype"] = "bfloat16"
    else:
        rec["data"] = data.numpy().copy()
    return rec


def _to_serializable(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return _record(obj)
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_serializable(v) for v in obj)
    return obj


def _host_tensor(rec: dict) -> torch.Tensor:
    data = rec["data"]
    if rec.get("dtype") == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(
            data, dtype=np.uint16).copy()).view(torch.bfloat16)
    return numpy_to_torch(data)


def _numpy(rec: dict):
    if rec.get("dtype") != "bfloat16":
        return rec["data"]
    try:
        import ml_dtypes
    except ImportError:
        return _host_tensor(rec).to(torch.float32).numpy()
    return np.ascontiguousarray(rec["data"], np.uint16).view(
        ml_dtypes.bfloat16)


def _from_serializable(obj: Any, return_numpy: bool, device) -> Any:
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return _numpy(obj)
            t = _host_tensor(obj).to(device)
            if obj.get("param"):
                return Parameter(t, trainable=not obj["stop_gradient"])
            if not obj.get("stop_gradient", True) and (
                    t.is_floating_point() or t.is_complex()):
                t.requires_grad_(True)
            return t
        return {k: _from_serializable(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_serializable(v, return_numpy, device)
                         for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4) -> None:
    """Pickle ``obj`` (tensors as records) to ``path``, atomically."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(_to_serializable(obj), f, protocol=protocol)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(path: str, return_numpy: bool = False) -> Any:
    """The object saved at ``path``, its tensors on the default device
    (numpy with ``return_numpy``)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    device = None if return_numpy else resolve_device()
    return _from_serializable(obj, return_numpy, device)
