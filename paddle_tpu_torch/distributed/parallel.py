"""``DataParallel`` of the PyTorch port.

Counterpart of ``paddle_tpu/distributed/parallel.py:19-151``. After every
``backward()`` that reaches the wrapped layer's parameters, their
gradients are averaged over the data-parallel group with no call from the
user, as the reference's post-backward hook does (``:36-49``) and as
PyTorch's DDP does: a post-accumulate-grad hook on each parameter queues
one callback at the end of the backward pass, which all-reduces the
gradients in buckets of ``comm_buffer_size`` MB, one dtype a bucket.
``no_sync()`` skips that (gradient accumulation); the next synchronised
backward averages what has accumulated.

A sparse gradient (``F.embedding(..., sparse=True)``: a COO tensor) is
averaged by ``_sync_selected_rows``: its rows and values gathered from
every rank (padded to the largest row count) and summed as one COO
tensor, divided by the world size.
"""
from __future__ import annotations

import contextlib
import weakref

import torch

from ..nn.layer.layers import Layer
from . import collective as C


def _bucketed_all_reduce(grads, group, bucket_bytes, average=True):
    """All-reduce ``grads`` (dense tensors) over ``group`` in place, packed
    into flat buckets of at most ``bucket_bytes`` (one dtype a bucket; a
    larger tensor goes alone: fleet's ``internal_storage``), each divided
    by the group's size when ``average``."""
    from .fleet.utils.internal_storage import reduce_in_place
    n = max(group.nranks, 1)

    def reduce(flat):
        C.all_reduce(flat, group=group)
        if average:
            flat.div_(n)
        return flat

    reduce_in_place(grads, reduce, bucket_bytes)


class DataParallel(Layer):
    """``paddle.DataParallel(layers, strategy, comm_buffer_size,
    last_comm_buffer_size, find_unused_parameters, group)``: the wrapped
    layer's forward, and its gradients averaged over ``group`` (the
    default group of every rank when None) after each backward."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.group = group
        self.comm_buffer_size = comm_buffer_size
        self.find_unused_parameters = find_unused_parameters
        self._grad_sync_enabled = True
        self._queued = False
        ref = weakref.ref(self)

        def on_grad(_param):
            dp = ref()
            if dp is None or dp._queued:
                return
            dp._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                dp._end_of_backward)

        self._hooks = [p.register_post_accumulate_grad_hook(on_grad)
                       for p in layers.parameters() if p.requires_grad]

    def _end_of_backward(self):
        self._queued = False
        if self._grad_sync_enabled:
            self.apply_collective_grads()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def no_sync(self):
        """Within it, backward leaves each rank's gradients unsynchronised
        (accumulation)."""
        @contextlib.contextmanager
        def ctx():
            prev = self._grad_sync_enabled
            self._grad_sync_enabled = False
            try:
                yield
            finally:
                self._grad_sync_enabled = prev

        return ctx()

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average every gradient over the group (dense ones bucketed)."""
        group = self.group or C._default_group()
        if C._pg(group) is None:
            return
        params = [p for p in self._layers.parameters() if p.grad is not None]
        for p in params:
            if p.grad.is_sparse:
                p.grad = self._sync_selected_rows(p.grad, group)
        _bucketed_all_reduce([p.grad for p in params if not p.grad.is_sparse],
                             group, self.comm_buffer_size * 1024 * 1024)

    @staticmethod
    def _sync_selected_rows(grad, group):
        """A sparse COO gradient averaged over ``group``: every rank's rows
        and values, padded to the largest count with row 0 and zero values
        (which add nothing), concatenated, divided by the group's size."""
        merged = grad.coalesce()
        rows, vals = merged.indices()[0], merged.values()
        n = torch.tensor([rows.numel()], device=rows.device)
        C.all_reduce(n, op=C.ReduceOp.MAX, group=group)
        pad = int(n.item()) - rows.numel()
        rows = torch.cat([rows, rows.new_zeros(pad)])
        vals = torch.cat([vals, vals.new_zeros((pad,) + vals.shape[1:])])
        all_rows = torch.cat(C.all_gather([], rows, group))
        all_vals = torch.cat(C.all_gather([], vals, group))
        return torch.sparse_coo_tensor(all_rows[None], all_vals / group.nranks,
                                       grad.shape).coalesce()

    # ---- the wrapped layer's surface -------------------------------------
    def parameters(self, include_sublayers=True, recurse=None):
        return self._layers.parameters(include_sublayers, recurse)

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        return self._layers.named_parameters(prefix, include_sublayers,
                                             remove_duplicate, recurse)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, state_dict, *a, **kw):
        return self._layers.set_state_dict(state_dict, *a, **kw)

    def scale_loss(self, loss):
        """Paddle's loss scaling for data parallelism: the gradients are
        averaged, so the loss stays as it is."""
        return loss
