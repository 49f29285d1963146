"""Fused flat buffers for parameters and gradients, for the PyTorch port.

Counterpart of ``paddle_tpu/distributed/fleet/utils/internal_storage.py``
(``TensorBucket``, ``GradStorage``, ``ParamStorage``,
``fused_all_reduce``): tensors bucketed by dtype under a byte budget (a
tensor larger than the budget goes alone), each bucket packed into one
flat tensor, so that a collective runs once a bucket instead of once a
tensor. ``DataParallel`` and the Llama step on a mesh average their
gradients through ``reduce_in_place``, which keeps one bucket's flat
tensor at a time.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


class TensorBucket:
    """One dtype's bucket of tensors with a flat fused form."""

    def __init__(self, dtype):
        self.dtype = dtype
        self._shapes: List[Tuple[int, ...]] = []
        self._sizes: List[int] = []
        self.tensors: List = []
        self._bytes = 0

    def add(self, value) -> int:
        """Register one tensor; returns its slot."""
        self._shapes.append(tuple(value.shape))
        self._sizes.append(value.numel())
        self.tensors.append(value)
        self._bytes += value.numel() * value.element_size()
        return len(self.tensors) - 1

    @property
    def numel(self) -> int:
        return sum(self._sizes)

    def pack(self) -> torch.Tensor:
        """Every registered tensor, flattened into one new tensor."""
        return torch.cat([t.reshape(-1).to(self.dtype)
                          for t in self.tensors])

    def unpack(self, flat) -> List[torch.Tensor]:
        """``flat`` cut back into the registered shapes (views)."""
        out, off = [], 0
        for shape, size in zip(self._shapes, self._sizes):
            out.append(flat[off:off + size].view(shape))
            off += size
        return out


class GradStorage:
    """Gradients bucketed by dtype under ``max_bucket_bytes``;
    ``assignments[i]`` is input i's (bucket, slot)."""

    def __init__(self, max_bucket_bytes: int = 25 * 1024 * 1024):
        self.max_bucket_bytes = max_bucket_bytes
        self.buckets: List[TensorBucket] = []
        self.assignments: List[Tuple[int, int]] = []

    def build(self, grads: List) -> List[TensorBucket]:
        current = {}
        for g in grads:
            cur = current.get(g.dtype)
            nbytes = g.numel() * g.element_size()
            if cur is None or cur._bytes + nbytes > self.max_bucket_bytes:
                cur = current[g.dtype] = TensorBucket(g.dtype)
                self.buckets.append(cur)
            slot = cur.add(g)
            self.assignments.append((self.buckets.index(cur), slot))
        return self.buckets


ParamStorage = GradStorage  # the same mechanics, as in the reference


def fused_all_reduce(grads: List, all_reduce_fn,
                     max_bucket_bytes: int = 25 * 1024 * 1024) -> List:
    """``grads`` all-reduced in fused dtype buckets: ``all_reduce_fn``
    takes a bucket's flat tensor and returns the reduced one. Returns the
    reduced gradients in the input order (views of the reduced flats)."""
    storage = GradStorage(max_bucket_bytes)
    buckets = storage.build(grads)
    reduced = [b.unpack(all_reduce_fn(b.pack())) for b in buckets]
    return [reduced[bi][ti] for bi, ti in storage.assignments]


def reduce_in_place(tensors: List, all_reduce_fn,
                    max_bucket_bytes: int = 25 * 1024 * 1024) -> None:
    """``fused_all_reduce`` written back into ``tensors``, one bucket at a
    time (one bucket's flat tensor alive at once)."""
    for bucket in GradStorage(max_bucket_bytes).build(tensors):
        flat = all_reduce_fn(bucket.pack())
        for t, r in zip(bucket.tensors, bucket.unpack(flat)):
            t.copy_(r)
