"""``HybridParallelOptimizer`` and its global-norm clip, for the PyTorch
port.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
hybrid_parallel_optimizer.py``. Before the inner optimizer's step, the
gradients are averaged over the data-parallel group (bucketed, as
``DataParallel`` does), and a ``ClipGradByGlobalNorm`` of the inner
optimizer becomes ``HybridParallelClipGrad``: the squared norms of the
parameters split over the model group are summed over it, those of the
replicated parameters counted once, so every rank clips by the norm of
the whole model.
"""
from __future__ import annotations

import torch

from ... import collective as C
from ...parallel import _bucketed_all_reduce


def _is_split(p, group):
    spec = getattr(p, "sharding_spec", None) or ()
    return group is not None and group.nranks > 1 and "model" in spec


class HybridParallelClipGrad:
    def __init__(self, clip, hcg):
        self._clip = clip
        self._hcg = hcg

    @torch.no_grad()
    def __call__(self, params, grads):
        group = self._hcg.get_model_parallel_group()
        dev = grads[0].device
        split = torch.zeros((), dtype=torch.float32, device=dev)
        whole = torch.zeros((), dtype=torch.float32, device=dev)
        for p, g in zip(params, grads):
            sq = torch.sum(torch.square(g.to(torch.float32)))
            if _is_split(p, group):
                split = split + sq
            else:
                whole = whole + sq
        if group.nranks > 1:
            C.all_reduce(split, group=group)
        norm = torch.sqrt(split + whole)
        scale = torch.clamp_max(self._clip.clip_norm
                                / torch.clamp_min(norm, 1e-12), 1.0)
        return [(g.to(torch.float32) * scale).to(g.dtype) for g in grads]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy):
        from ....nn import ClipGradByGlobalNorm
        self._inner = optimizer
        self._hcg = hcg
        self._strategy = strategy
        clip = optimizer._grad_clip
        self._hybrid_clip = None
        if isinstance(clip, ClipGradByGlobalNorm):
            self._hybrid_clip = HybridParallelClipGrad(clip, hcg)
            optimizer._grad_clip = None

    def _params(self):
        return [p for p in self._inner._parameters
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def _sync_dp_grads(self):
        group = self._hcg.get_data_parallel_group()
        if group.nranks > 1:
            _bucketed_all_reduce([p.grad for p in self._params()], group,
                                 32 * 1024 * 1024)

    @torch.no_grad()
    def step(self):
        self._sync_dp_grads()
        if self._hybrid_clip is not None:
            params = self._params()
            clipped = self._hybrid_clip(params, [p.grad for p in params])
            for p, g in zip(params, clipped):
                p.grad = g
        self._inner.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero: bool = False):
        self._inner.clear_grad()

    clear_gradients = clear_grad

    def __getattr__(self, name):
        return getattr(self._inner, name)
