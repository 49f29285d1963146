"""Gradient-communication meta-optimizers of the PyTorch port.

Counterpart of ``paddle_tpu/distributed/fleet/meta_optimizers.py``: three
eager wrappers around an inner optimizer of the port (``optimizer``),
which see its parameters and their ``.grad`` and talk over the port's
collectives (``collective``):

* ``GradientMergeOptimizer`` (``:18``): gradients accumulated for
  ``k_steps`` calls of ``step``, then (averaged with ``avg``) applied;
* ``LocalSGDOptimizer`` (``:59``): local steps, the parameters averaged
  over the group every ``k_steps``;
* ``DGCMomentumOptimizer`` (``:88``): deep gradient compression, each
  gradient (plus its residual) cut to its top (1 - ``sparsity``) share by
  magnitude, the rest kept as the next residual, the sparse gradients
  averaged over the group before the inner step.

Anything else is the inner optimizer's (``__getattr__``).
"""
from __future__ import annotations

import torch

from .. import collective as C


class _Wrapper:
    def __init__(self, inner_optimizer):
        self.inner = inner_optimizer

    def _params(self):
        return self.inner._parameters

    def clear_grad(self):
        self.inner.clear_grad()

    clear_gradients = clear_grad

    def __getattr__(self, name):
        return getattr(self.inner, name)


class GradientMergeOptimizer(_Wrapper):
    """Accumulate gradients for ``k_steps`` calls, then apply them."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        super().__init__(inner_optimizer)
        self.k_steps = k_steps
        self.avg = avg
        self._acc = {}
        self._count = 0

    @torch.no_grad()
    def step(self):
        self._count += 1
        for p in self._params():
            if p.grad is not None:
                acc = self._acc.get(id(p))
                self._acc[id(p)] = p.grad.clone() if acc is None \
                    else acc + p.grad
                p.grad = None
        if self._count >= self.k_steps:
            for p in self._params():
                acc = self._acc.get(id(p))
                if acc is not None:
                    p.grad = acc / self._count if self.avg else acc
            self.inner.step()
            self.inner.clear_grad()
            self._acc = {}
            self._count = 0

    def clear_grad(self):
        for p in self._params():
            p.grad = None

    clear_gradients = clear_grad


class LocalSGDOptimizer(_Wrapper):
    """Local updates; every ``k_steps`` the parameters averaged over
    ``group`` (every rank when None)."""

    def __init__(self, inner_optimizer, k_steps=1, group=None):
        super().__init__(inner_optimizer)
        self.k_steps = k_steps
        self.group = group
        self._count = 0

    @torch.no_grad()
    def step(self):
        self.inner.step()
        self._count += 1
        if self._count % self.k_steps == 0:
            world = C.get_world_size(self.group)
            if world > 1:
                for p in self._params():
                    C.all_reduce(p.data, group=self.group)
                    p.data.div_(world)


class DGCMomentumOptimizer(_Wrapper):
    """Top-k sparsified gradients averaged over ``group``, the rest kept
    locally as a residual added to the next gradient."""

    def __init__(self, inner_optimizer, rampup_begin_step=0, sparsity=0.999,
                 group=None):
        super().__init__(inner_optimizer)
        self.sparsity = sparsity
        self.group = group
        self._residual = {}

    @torch.no_grad()
    def step(self):
        world = C.get_world_size(self.group)
        for p in self._params():
            if p.grad is None:
                continue
            g = p.grad + self._residual[id(p)] if id(p) in self._residual \
                else p.grad.clone()
            k = max(1, int(round(g.numel() * (1 - self.sparsity))))
            flat = g.abs().reshape(-1)
            if k < flat.numel():
                thresh = torch.sort(flat).values[-k]
                sparse = torch.where(g.abs() >= thresh, g,
                                     torch.zeros_like(g))
            else:
                sparse = g
            self._residual[id(p)] = g - sparse
            p.grad = sparse
            if world > 1:
                C.all_reduce(p.grad, group=self.group)
                p.grad.div_(world)
        self.inner.step()
