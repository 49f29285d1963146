"""Dtype names for the PyTorch port (counterpart of
``paddle_tpu/core/dtype.py``): the same string aliases, mapped to
``torch.dtype`` objects, plus the numpy -> torch conversion the weight
bridge needs for bfloat16 arrays."""
from __future__ import annotations

import numpy as np
import torch

_STR_ALIASES = {
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "fp64": torch.float64,
    "double": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int": torch.int32, "int64": torch.int64, "long": torch.int64,
    "uint8": torch.uint8, "uint16": torch.uint16, "uint32": torch.uint32,
    "uint64": torch.uint64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


def convert_dtype(d) -> torch.dtype:
    """A dtype name, a numpy dtype or a torch dtype -> ``torch.dtype``."""
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        if d not in _STR_ALIASES:
            raise TypeError(f"unsupported dtype string: {d!r}")
        return _STR_ALIASES[d]
    name = np.dtype(d).name
    if name not in _STR_ALIASES:
        raise TypeError(f"cannot interpret {d!r} as a torch dtype")
    return _STR_ALIASES[name]


def dtype_name(d) -> str:
    return str(convert_dtype(d)).removeprefix("torch.")


def numpy_to_torch(a) -> torch.Tensor:
    """An ndarray -> a CPU tensor sharing no memory with it. bfloat16
    arrays (ml_dtypes, which is what ``np.asarray`` of a JAX bf16 array
    gives) go through a uint16 view, since ``torch.from_numpy`` refuses
    that dtype; the bits are kept exactly."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())
