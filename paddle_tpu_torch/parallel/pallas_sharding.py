"""Attention kernels on a rank's own heads, for the PyTorch port's tensor
parallelism.

Counterpart of ``paddle_tpu/parallel/pallas_sharding.py:27-63``. The
reference cannot let GSPMD partition a Pallas call, so it wraps the flash
kernels in a ``shard_map`` whose head dimension is manual over the model
axis. In the port each rank of the model group already holds its heads
(the column-parallel projections give them), so there is nothing to
partition: this module is the one place that checks the head counts
against the model axis (``local_heads``) and calls the kernel on the local
heads (``shard_map_attention``). ``ENGAGED`` records that such a call ran
and the (query, key/value) head counts it gave the kernel.

Where the kv head count does not divide the axis, each rank reads the kv
heads its query heads use from the gathered k/v projections (``LocalHeads
.kv_index``); a query head count that does not divide raises.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

# test hook: set whenever a call ran on a rank's local heads, with the
# head counts the kernel saw
ENGAGED = {"flag": False, "heads": None}


@dataclasses.dataclass(frozen=True)
class LocalHeads:
    """The heads of rank ``rank`` of ``n``: query heads ``q_start`` ..
    ``q_start + q_count``; kv heads ``kv_start`` .. ``kv_start +
    kv_count`` of the split projections, or (``kv_index`` set) those
    indices of the gathered ones, one per local group of
    ``q_count // len(kv_index)`` query heads."""
    q_start: int
    q_count: int
    kv_start: int
    kv_count: int
    kv_index: Optional[List[int]] = None


def local_heads(num_heads: int, num_kv_heads: int, n: int,
                rank: int) -> LocalHeads:
    if num_heads % n:
        raise ValueError(f"{num_heads} query heads do not divide over a "
                         f"model axis of {n}")
    qc = num_heads // n
    q0 = rank * qc
    if num_kv_heads % n == 0:
        kc = num_kv_heads // n
        return LocalHeads(q0, qc, rank * kc, kc)
    group = num_heads // num_kv_heads
    per_q = [(q0 + i) // group for i in range(qc)]
    kv = sorted(set(per_q))
    g = qc // len(kv)
    if qc % len(kv) or any(per_q[i] != kv[i // g] for i in range(qc)):
        kv = per_q                     # one kv head a query head
    return LocalHeads(q0, qc, kv[0], len(kv), list(kv))


def shard_map_attention(fn, q, k, v, mesh=None, head_axis: str = "model",
                        batch_axis: str = "data", num_heads=None):
    """``fn(q, k, v)`` on this rank's heads: q (B, Hq, S, D) and k, v (B,
    Hkv, S, D) hold the rank's heads already. With a model axis of several
    ranks, Hq times the axis must be ``num_heads`` (when given) and Hkv
    must divide Hq; ``ENGAGED`` records the call. Without one, a plain
    call. ``batch_axis`` is accepted for the reference's signature: each
    rank's batch is its own already."""
    if mesh is None:
        from ..distributed.topology import get_global_mesh
        mesh = get_global_mesh()
    n = mesh.shape.get(head_axis, 1) if mesh is not None else 1
    if n <= 1:
        return fn(q, k, v)
    if num_heads is not None and q.shape[1] * n != num_heads:
        raise ValueError(f"q holds {q.shape[1]} heads; a model axis of {n} "
                         f"gives each rank {num_heads // n} of {num_heads}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"{k.shape[1]} local kv heads do not divide "
                         f"{q.shape[1]} local query heads")
    out = fn(q, k, v)
    ENGAGED["flag"] = True
    ENGAGED["heads"] = (int(q.shape[1]), int(k.shape[1]))
    return out
