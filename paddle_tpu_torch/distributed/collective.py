"""The eager collective API of the PyTorch port, over ``torch.distributed``.

Counterpart of ``paddle_tpu/distributed/collective.py`` (``ReduceOp``,
``Task``, ``new_group``, ``get_group``, ``all_reduce``, ``broadcast``,
``all_gather``, ``reduce``, ``scatter``, ``alltoall``, ``send``, ``recv``,
``barrier``, ``wait``, ``split``, ``destroy_process_group``), with the
reference's arguments (``:148-299``). ``group`` is a ``ParallelGroup``
(``topology.py``); None is the default group of every rank. Each function
is in place on its tensor, as Paddle's; ``sync_op=False`` returns a
``Task`` over the backend's work handle, and otherwise the tensor (or the
list) comes back.

With no process group the world is one rank and every collective is the
identity, as in the reference's single process (``:1-15``: "groups
degenerate to identity (world_size 1)"). Once a group exists, every call
goes to its backend, a group of one rank included. A collective that the
backend refuses for a tensor raises; nothing moves the tensor elsewhere.
gloo takes CUDA tensors (staged through host memory) in ``all_reduce``,
``all_gather``, ``broadcast``, ``reduce``, ``scatter`` and ``barrier``
(PyTorch 2.11 on an H100), refuses its list ``alltoall``, and would end the
process on a CUDA ``send`` / ``recv``, which the port refuses first.

The reference's ``psum_in_jit`` has no counterpart: the port has no
compiled SPMD program to place a collective in. The model-parallel
layers' differentiable collectives (``c_identity``, ``mp_allreduce``,
``c_concat``, ``c_split``: Paddle's names) are ``torch.autograd``
functions over the same calls, and so is ``all_reduce_with_grad``: a sum
over the ranks that every rank's loss reads (the global statistics of a
synchronised batch norm, the MoE router's global means), whose gradient
is the sum of the ranks' gradients.

``STATS`` counts the collectives' calls, bytes and host seconds; with
``STATS["sync"]`` set, the device is synchronised before and after each
call so that its seconds are the collective's alone. The context-parallel
transport (``ring_shift``, ``all_to_all_tiled``: the K/V rotation of ring
attention and Ulysses' exchanges) counts there too, and the part of it
staged through host memory under ``staged_calls``, ``staged_bytes`` and
``staged_seconds``.
"""
from __future__ import annotations

import datetime
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from . import env as _env
from .topology import ParallelGroup


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "sync": False,
         "staged_calls": 0, "staged_bytes": 0, "staged_seconds": 0.0}


def reset_stats(sync: bool = False):
    STATS.update(calls=0, bytes=0, seconds=0.0, sync=bool(sync),
                 staged_calls=0, staged_bytes=0, staged_seconds=0.0)


class Task:
    """An asynchronous collective (``ProcessGroup`` ``Task``:
    ``is_completed`` / ``wait(timeout)`` / ``synchronize``) over the
    backend's work handle; ``after`` runs once the work has ended (an
    average's division). The identity collectives give a finished task."""

    def __init__(self, work=None, result=None, after=None):
        self._work = work
        self._after = after
        self.result = result

    def _finish(self):
        if self._after is not None:
            after, self._after = self._after, None
            after()

    def is_completed(self) -> bool:
        done = self._work is None or self._work.is_completed()
        if done:
            self._finish()
        return done

    def wait(self, timeout=None) -> bool:
        """Block until the collective ends, or ``timeout`` seconds pass
        (then False)."""
        if self._work is not None:
            if timeout is None:
                self._work.wait()
            elif not self._work.wait(
                    timeout=datetime.timedelta(seconds=timeout)):
                return False
        self._finish()
        return True

    def synchronize(self) -> None:
        self.wait()


_groups = {}
_group_counter = 0


def _default_group() -> ParallelGroup:
    """Every rank, over the default process group (made again when that
    group comes or goes)."""
    pg = dist.group.WORLD if _env.is_initialized() else None
    g = _groups.get(0)
    if g is None or g.process_group is not pg:
        g = _groups[0] = ParallelGroup(list(range(_env.get_world_size())),
                                       _env.get_rank(), "data", 0,
                                       process_group=pg)
    return g


def _resolve(group) -> ParallelGroup:
    return _default_group() if group is None else group


def _pg(group: ParallelGroup):
    """The process group of ``group``, or None where the collective is the
    identity: no process group, or a one-rank group made without one."""
    if not _env.is_initialized():
        return None
    if group.process_group is None:
        if group.nranks <= 1:
            return None
        raise RuntimeError(f"{group} has no process group")
    return group.process_group


def new_group(ranks=None, backend=None, timeout=None) -> ParallelGroup:
    """``paddle.distributed.new_group``: every rank of the world calls it,
    members or not."""
    global _group_counter
    _group_counter += 1
    if ranks is None:
        ranks = list(range(_env.get_world_size()))
    pg = None
    if _env.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(list(ranks), backend=backend, **kw)
    g = ParallelGroup(list(ranks), _env.get_rank(), "custom", _group_counter,
                      process_group=pg)
    _groups[_group_counter] = g
    return g


def get_group(gid: int = 0) -> Optional[ParallelGroup]:
    if gid == 0:
        return _default_group()
    return _groups.get(gid)


def is_initialized() -> bool:
    return _env.is_initialized()


def _call(fn, tensors, sync_op, result, after=None):
    """Run the backend call ``fn(async_op)`` and account for it: a Task
    when not ``sync_op``, else wait and return ``result``."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    STATS["calls"] += 1
    STATS["bytes"] += nbytes
    timed = STATS["sync"] and any(t.is_cuda for t in tensors)
    if timed:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    work = fn(not sync_op)
    if not sync_op:
        return Task(work, result, after)
    if work is not None:
        work.wait()
    if timed:
        torch.cuda.synchronize()
    STATS["seconds"] += time.perf_counter() - t0
    if after is not None:
        after()
    return result


def _done(result, sync_op):
    return result if sync_op else Task(None, result)


def _average(tensor, n):
    """In place: ``tensor`` (the sum over ``n`` ranks) made the mean, cast
    back to its dtype (truncated for an integer tensor), as the
    reference's ``jnp.mean(...).astype(dtype)``."""
    if tensor.is_floating_point() or tensor.is_complex():
        tensor.div_(n)
    else:
        tensor.copy_(torch.div(tensor.double(), n).to(tensor.dtype))


def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM, group=None,
               sync_op=True):
    """In place: the reduction of ``tensor`` over the group's ranks
    (``AVG``: the mean in the tensor's dtype)."""
    group = _resolve(group)
    pg = _pg(group)
    if pg is None:
        return _done(tensor, sync_op)
    after = None
    if op == ReduceOp.AVG:
        def after():
            _average(tensor, group.nranks)
    return _call(lambda a: dist.all_reduce(tensor, _TORCH_OP[op], group=pg,
                                           async_op=a),
                 [tensor], sync_op, tensor, after)


def broadcast(tensor: torch.Tensor, src: int, group=None, sync_op=True):
    """In place: rank ``src``'s tensor (``src`` a global rank)."""
    group = _resolve(group)
    pg = _pg(group)
    if pg is None:
        return _done(tensor, sync_op)
    return _call(lambda a: dist.broadcast(tensor, src, group=pg, async_op=a),
                 [tensor], sync_op, tensor)


def all_gather(tensor_list: List, tensor: torch.Tensor, group=None,
               sync_op=True):
    """Appends every rank's ``tensor`` to ``tensor_list``, in group
    order."""
    group = _resolve(group)
    pg = _pg(group)
    if pg is None:
        tensor_list.extend(tensor.clone()
                           for _ in range(max(group.nranks, 1)))
        return _done(tensor_list, sync_op)
    out = [torch.empty_like(tensor) for _ in range(group.nranks)]
    tensor_list.extend(out)
    return _call(lambda a: dist.all_gather(out, tensor.contiguous(),
                                           group=pg, async_op=a),
                 [tensor], sync_op, tensor_list)


def reduce(tensor: torch.Tensor, dst: int, op=ReduceOp.SUM, group=None,
           sync_op=True):
    """In place on every rank of the group: the reduction, as in the
    reference, whose ``reduce`` is an ``all_reduce``
    (``paddle_tpu/distributed/collective.py:193-197``); ``dst`` is
    accepted for Paddle's signature."""
    return all_reduce(tensor, op=op, group=group, sync_op=sync_op)


def scatter(tensor: torch.Tensor, tensor_list=None, src=0, group=None,
            sync_op=True):
    """In place: entry ``group.rank`` of rank ``src``'s ``tensor_list``."""
    group = _resolve(group)
    pg = _pg(group)
    if pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return _done(tensor, sync_op)
    parts = ([t.contiguous() for t in tensor_list]
             if _env.get_rank() == src else None)
    return _call(lambda a: dist.scatter(tensor, parts, src=src, group=pg,
                                        async_op=a),
                 [tensor], sync_op, tensor)


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True):
    """Entry j of ``in_tensor_list`` goes to the group's rank j;
    ``out_tensor_list`` receives, in group order, what each rank sent this
    one."""
    group = _resolve(group)
    pg = _pg(group)
    if pg is None:
        out_tensor_list.extend(t.clone() for t in in_tensor_list)
        return _done(out_tensor_list, sync_op)
    out = [torch.empty_like(t) for t in in_tensor_list]
    out_tensor_list.extend(out)
    return _call(lambda a: dist.all_to_all(
        out, [t.contiguous() for t in in_tensor_list], group=pg, async_op=a),
        list(in_tensor_list), sync_op, out_tensor_list)


# ---- the context-parallel transport ---------------------------------------

def _staged(pg, tensors) -> bool:
    """Whether ``tensors`` move through pinned host memory: CUDA tensors
    over gloo, whose send / recv cannot take device memory (and whose list
    all-to-all refuses it)."""
    return dist.get_backend(pg) == "gloo" and any(t.is_cuda for t in tensors)


def _host_copy(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _start(tensors):
    """The transfer's start on the host clock; with ``STATS["sync"]`` the
    card's queued work finished first, so that the seconds are the
    transfer's alone."""
    if STATS["sync"] and any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    return time.perf_counter()


def _account(tensors, staged, t0):
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    seconds = time.perf_counter() - t0
    STATS["calls"] += 1
    STATS["bytes"] += nbytes
    STATS["seconds"] += seconds
    if staged:
        STATS["staged_calls"] += 1
        STATS["staged_bytes"] += nbytes
        STATS["staged_seconds"] += seconds


def ring_shift(tensors, group: ParallelGroup, offset: int = 1):
    """Each rank of ``group`` sends ``tensors`` to group rank r + offset
    and receives the same shapes from r - offset (``dist.batch_isend_irecv``;
    ``offset`` taken modulo the group's size); returns what it received,
    on the tensors' device. The ring of ring attention.

    The backend decides how the bytes move: under NCCL the device tensors
    themselves; under gloo a CUDA tensor is copied into pinned host memory,
    sent, and the received host tensor copied back to the card (gloo ends
    the process on a CUDA send). The attention kernels still run on the
    card; only the transfer goes through the host. A shift by a multiple of
    the group's size returns the tensors themselves."""
    n = max(group.nranks, 1)
    pg = _pg(group)
    if pg is None or offset % n == 0:
        return list(tensors)
    r = group.rank
    dst, src = group.ranks[(r + offset) % n], group.ranks[(r - offset) % n]
    staged = _staged(pg, tensors)
    t0 = _start(tensors)
    send = [_host_copy(t) if staged else t.contiguous() for t in tensors]
    recv = [torch.empty(t.shape, dtype=t.dtype, device=t.device,
                        pin_memory=staged) for t in send]
    ops = ([dist.P2POp(dist.isend, t, dst, pg, tag=i)
            for i, t in enumerate(send)]
           + [dist.P2POp(dist.irecv, t, src, pg, tag=i)
              for i, t in enumerate(recv)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = [h.to(t.device) for h, t in zip(recv, tensors)] if staged else recv
    if STATS["sync"] and tensors[0].is_cuda:
        torch.cuda.synchronize()
    _account(tensors, staged, t0)
    return out


def all_to_all_tiled(x: torch.Tensor, group: ParallelGroup, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all (``jax.lax.all_to_all(..., tiled=True)``): x
    cut into the group's size along ``split_axis``, part j to group rank
    j, and the parts received concatenated along ``concat_axis`` in group
    order (``dist.all_to_all_single``). Ulysses' exchange. A CUDA tensor
    moves as in ``ring_shift``: itself under NCCL, through pinned host
    memory under gloo."""
    n = max(group.nranks, 1)
    pg = _pg(group)
    if pg is None:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"dimension {split_axis} of {tuple(x.shape)} does "
                         f"not divide over {n} ranks")
    staged = _staged(pg, [x])
    t0 = _start([x])
    parts = torch.stack(x.chunk(n, dim=split_axis), 0)
    send = _host_copy(parts) if staged else parts
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device,
                       pin_memory=staged)
    dist.all_to_all_single(recv, send, group=pg)
    if staged:
        recv = recv.to(x.device)
    if STATS["sync"] and x.is_cuda:
        torch.cuda.synchronize()
    _account([x], staged, t0)
    return torch.cat(recv.unbind(0), dim=concat_axis)


_p2p_buffer: list = []


def _check_p2p(tensor, pg):
    """gloo's send and recv hand a CUDA tensor's device address to the
    socket, which fails inside gloo and ends the process: refused here."""
    if tensor.is_cuda and dist.get_backend(pg) == "gloo":
        raise RuntimeError("send / recv of a CUDA tensor over gloo: gloo "
                           "sends host memory only (use NCCL, or a CPU "
                           "tensor)")


def send(tensor: torch.Tensor, dst: int, group=None, sync_op=True):
    """To rank ``dst`` (a global rank). With no process group, into this
    process's buffer, which ``recv`` reads back (the reference's)."""
    if not _env.is_initialized():
        _p2p_buffer.append(tensor.clone())
        return _done(tensor, sync_op)
    pg = _pg(_resolve(group))
    _check_p2p(tensor, pg)

    def fn(async_op):
        if async_op:
            return dist.isend(tensor, dst, group=pg)
        dist.send(tensor, dst, group=pg)
    return _call(fn, [tensor], sync_op, tensor)


def recv(tensor: torch.Tensor, src: int, group=None, sync_op=True):
    """In place: what rank ``src`` sent."""
    if not _env.is_initialized():
        if _p2p_buffer:
            tensor.copy_(_p2p_buffer.pop(0))
        return _done(tensor, sync_op)
    pg = _pg(_resolve(group))
    _check_p2p(tensor, pg)

    def fn(async_op):
        if async_op:
            return dist.irecv(tensor, src, group=pg)
        dist.recv(tensor, src, group=pg)
    return _call(fn, [tensor], sync_op, tensor)


def barrier(group=None):
    group = _resolve(group)
    pg = _pg(group)
    if pg is not None:
        dist.barrier(group=pg)


def wait(tensor: torch.Tensor, group=None, use_calc_stream=True):
    """The port's collectives finish on their own stream before they
    return; this waits for the device's work on ``tensor``."""
    if tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)


def get_rank(group=None) -> int:
    if group is not None:
        return group.rank
    return _env.get_rank()


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return _env.get_world_size()


def destroy_process_group(group=None):
    """Destroy ``group``'s process group, or (None) every group and the
    default one."""
    if group is None:
        _groups.clear()
        if _env.is_initialized():
            dist.destroy_process_group()
        return
    _groups.pop(group.id, None)
    if _env.is_initialized() and group.process_group is not None \
            and group.process_group is not dist.group.WORLD:
        dist.destroy_process_group(group.process_group)


def split(x, num_partitions, rank=None, axis=0):
    """``paddle.distributed.split`` as the reference has it: part ``rank``
    (this rank by default) of ``x`` cut into ``num_partitions`` along
    ``axis``."""
    rank = rank if rank is not None else _env.get_rank()
    return torch.tensor_split(x, num_partitions, dim=axis)[
        rank % num_partitions]


# ---- differentiable collectives of the model-parallel layers --------------

def _all_gather_last(x, group):
    parts = all_gather([], x.contiguous(), group)
    return torch.cat(parts, dim=-1)


def _own_last(x, group):
    n = max(group.nranks, 1)
    size = x.shape[-1] // n
    r = max(group.rank, 0)
    return x[..., r * size:(r + 1) * size].contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, group=ctx.group)
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, group=ctx.group)
        return g, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, partial):
        ctx.group, ctx.partial = group, partial
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = g.contiguous().clone()
            all_reduce(g, group=ctx.group)
        return _own_last(g, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.group), None


def c_identity(x, group):
    """Identity forward; the gradient all-reduced over ``group`` (the input
    of a column-parallel product, replicated over the group)."""
    return _Identity.apply(x, group)


def mp_allreduce(x, group):
    """Sum over ``group`` forward; the gradient passed through (the output
    of a row-parallel product)."""
    return _AllReduce.apply(x, group)


def all_reduce_with_grad(x, group):
    """The sum of the ranks' ``x`` over ``group``, forward; backward, the
    sum of the ranks' gradients of it. Each rank's loss reads the sum, so
    the gradient of the sum of the ranks' losses reaches every ``x``: with
    gradients then averaged over the group, the gradient of the global
    objective (``torch.distributed.nn``'s ``all_reduce``)."""
    return _AllReduceWithGrad.apply(x, group)


def c_concat(x, group, partial_grad=False):
    """The ranks' ``x`` concatenated on the last dimension, in group order;
    the gradient's own block back. ``partial_grad``: each rank's gradient
    of the concatenation is a part of the whole (the ranks use different
    columns of it), so it is summed over the group first."""
    return _Concat.apply(x, group, partial_grad)


def c_split(x, group):
    """This rank's block of the last dimension; the gradient gathered."""
    return _Split.apply(x, group)
