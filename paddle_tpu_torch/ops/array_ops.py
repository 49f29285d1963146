"""TensorArray ops of the PyTorch port.

Counterpart of ``paddle_tpu/ops/array_ops.py``: eagerly a TensorArray is
a Python list of tensors. Indices are Python ints or scalar integer
tensors; ``array_write`` at ``len(array)`` appends.
"""
from __future__ import annotations

import torch

from ..core.place import resolve_device
from ._util import as_tensor

__all__ = ["create_array", "array_write", "array_read", "array_length"]


def _index(i) -> int:
    return int(i.item()) if isinstance(i, torch.Tensor) else int(i)


def create_array(dtype: str = "float32", initialized_list=None) -> list:
    """A new TensorArray, holding ``initialized_list`` if given
    (``dtype`` is accepted and unused, as in the reference)."""
    return list(initialized_list) if initialized_list is not None else []


def array_write(x, i, array: list | None = None) -> list:
    """Write ``x`` at ``i``; appends when ``i == len(array)``."""
    if array is None:
        array = []
    idx = _index(i)
    if idx > len(array):
        raise IndexError(
            f"array_write index {idx} beyond array length {len(array)}")
    x = as_tensor(x)
    if idx == len(array):
        array.append(x)
    else:
        array[idx] = x
    return array


def array_read(array: list, i):
    return array[_index(i)]


def array_length(array: list) -> torch.Tensor:
    """The length as an int32 scalar on the default device."""
    return torch.tensor(len(array), dtype=torch.int32,
                        device=resolve_device(None))
