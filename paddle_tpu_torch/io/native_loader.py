"""Native batch assembly of the PyTorch port.

Counterpart of ``paddle_tpu/io/native_loader.py`` (``NativeBatchAssembler``):
``csrc/batch_loader.cc``'s threads gather rows of one contiguous array
into batches outside the GIL. The reference falls back to numpy fancy
indexing without its library; here the library is built at construction
(``utils.native``) and a failed build raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from ..utils import native as _native


class NativeBatchAssembler:
    """Gathers rows of one contiguous array into batches with C++
    threads: ``submit`` a batch's indices, ``next`` takes the batches back
    in the order submitted."""

    def __init__(self, array: np.ndarray, n_threads: int = 4,
                 queue_cap: int = 8):
        self.array = np.ascontiguousarray(array)
        self.sample_bytes = int(self.array.dtype.itemsize
                                * np.prod(self.array.shape[1:]))
        self._lib = _native.get_lib()
        self._handle = self._lib.bl_create(
            self.array.ctypes.data_as(ctypes.c_void_p),
            self.array.shape[0], self.sample_bytes, 0, n_threads, queue_cap)

    @property
    def native(self) -> bool:
        """True while the native loader is open (always, from
        construction to ``close``)."""
        return self._handle is not None

    def submit(self, indices: Sequence[int]) -> None:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        self._lib.bl_submit(self._handle,
                            idx.ctypes.data_as(ctypes.c_void_p), len(idx))

    def next(self, batch_len: int) -> np.ndarray:
        out = np.empty((batch_len,) + self.array.shape[1:],
                       dtype=self.array.dtype)
        n = self._lib.bl_next(self._handle,
                              out.ctypes.data_as(ctypes.c_void_p))
        if n != out.nbytes:
            raise RuntimeError(f"native batch of {n} bytes, expected "
                               f"{out.nbytes}")
        return out

    def close(self):
        if self._handle is not None:
            self._lib.bl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
