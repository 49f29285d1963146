"""The optimizer base and the nine optimizers of the PyTorch port.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``. Each optimizer
defines the reference's ``_update(param, grad, accs, lr, t) -> (new
param, new accs)``, operation for operation, over float32 gradients and
accumulators, ``lr`` and the step ``t`` as float32 scalars on the
parameter's device. ``AdamW``'s is ``models.nlp.train_utils.adamw_update``,
the rule of the port's train-step factories (the same formula as the
reference's ``Adam._update`` with decoupled decay).

``step()`` updates every parameter with ``requires_grad`` and a
``.grad``, in place, one tensor at a time (eager, like the reference's
per-tensor rule inside its one jitted update):

* ``multi_precision``: a bfloat16 / float16 parameter keeps a float32
  master in its accumulators (``_master``); the rule runs on the master
  and the parameter receives its downcast;
* ``grad_clip`` (``nn.ClipGradByValue`` / ``ByNorm`` / ``ByGlobalNorm``)
  is applied to the gradients first (``_apply_grad_clip``);
* a sparse COO gradient (``F.embedding(..., sparse=True)``) takes the lazy
  row step (``_sparse_step``): only the rows it holds move, in the
  parameter and in its row-shaped accumulators. With a global-norm clip
  and dense gradients beside it, one norm covers both.

Kept as the reference has them (ROADMAP Queue 3): ``AdamW`` stores
``apply_decay_param_fun`` and never reads it (every parameter decays) and
ignores ``lr_ratio`` and ``lazy_mode``; ``Lamb`` ignores
``exclude_from_weight_decay_fn``; no optimizer reads a parameter's
``optimize_attr`` (``ParamAttr.learning_rate``), ``regularizer`` or
``need_clip``; a regularizer given as ``weight_decay`` raises TypeError at
the step (it has no product with a tensor); ``clear_grad`` sets every
gradient to None whatever ``set_to_zero`` says.

ZeRO (``distributed.sharding.group_sharded_parallel`` sets
``_shard_states_axis``, ``_offload_states`` and ``_sharding_group``): each
rank of the sharding group keeps its slice of every accumulator (and
master), on the dimension the reference splits a state over (``:150-160``:
the parameter's own "sharding" dimension at stage 3, else its largest
dimension that the group divides), updates that slice of the parameter and
all-gathers the parameter. The rules are elementwise, so the sliced update
gives the bits of the whole one; a parameter with no divisible dimension is
updated whole on every rank. ``Lamb``, whose trust ratio takes the norms of
the whole parameter, and sparse gradients are refused there.
``_offload_states`` keeps the accumulators in pinned host memory between
steps.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..models.nlp.train_utils import adamw_update
from .lr import LRScheduler

_LOW = (torch.bfloat16, torch.float16)


def _global_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads))


def _scale_of(clip_norm, norm):
    return torch.clamp_max(clip_norm / torch.clamp_min(norm, 1e-12), 1.0)


def _shard_dim(p, n):
    """The dimension of ``p`` whose slices ``n`` ranks update: the one its
    ``sharding_spec`` names "sharding" (stage 3), else the largest (the
    first of equals) that is not split over another axis and that ``n``
    divides; None when there is none (the reference's ``_state_sharding``,
    ``optimizer/optimizer.py:123-136``)."""
    spec = list(getattr(p, "sharding_spec", None) or ())
    spec += [None] * (p.dim() - len(spec))
    if "sharding" in spec:
        d = spec.index("sharding")
        if p.shape[d] % n == 0:
            return d
        spec[d] = None
    for d in sorted(range(p.dim()), key=lambda i: -p.shape[i]):
        if spec[d] is None and p.shape[d] % n == 0 and p.shape[d] >= n:
            return d
    return None


def _to_host(t):
    """``t`` in host memory, pinned when it comes from the card."""
    if not t.is_cuda:
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _merge(grad):
    """A sparse COO gradient -> (its distinct rows, ascending; their
    values summed in float32)."""
    vals = grad._values().to(torch.float32)
    merged = torch.sparse_coo_tensor(grad._indices(), vals,
                                     (grad.shape[0],) + vals.shape[1:],
                                     check_invariants=False).coalesce()
    return merged.indices()[0], merged.values()


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        self._lr = learning_rate
        self._parameters: List[torch.Tensor] = (list(parameters)
                                                if parameters else [])
        self._weight_decay = 0.0 if weight_decay is None else weight_decay
        self._grad_clip = grad_clip
        self._accumulators: Dict[int, dict] = {}
        self._step_count = 0
        self._multi_precision = bool(multi_precision)

    # ---- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = value

    # ---- subclass interface ----------------------------------------------
    def _create_accumulators(self, p) -> dict:
        return {}

    def _update(self, param, grad, accs, lr, t):
        raise NotImplementedError

    # ---- helpers ----------------------------------------------------------
    def _update_with_master(self, v, g, a, lr, t):
        """The rule on the float32 master when ``a`` holds one (the
        parameter receives its downcast), else on the parameter."""
        master = a.get("_master")
        if master is None:
            return self._update(v, g, a, lr, t)
        rest = {k: x for k, x in a.items() if k != "_master"}
        nm, na = self._update(master, g, rest, lr, t)
        na = dict(na)
        na["_master"] = nm
        return nm.to(v.dtype), na

    def _accs_for(self, p, like=None) -> dict:
        """``p``'s accumulators, made at their first use in the shape of
        ``like`` (a slice of ``p`` under ZeRO; ``p`` itself by default),
        in pinned host memory under ``_offload_states``."""
        if id(p) not in self._accumulators:
            src = p if like is None else like
            accs = self._create_accumulators(src)
            if self._multi_precision and p.dtype in _LOW:
                accs["_master"] = src.detach().to(torch.float32)
            if getattr(self, "_offload_states", False):
                accs = {k: _to_host(v) for k, v in accs.items()}
            self._accumulators[id(p)] = accs
        return self._accumulators[id(p)]

    @staticmethod
    def _zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def _scalars(self, device):
        """(lr, t) as float32 scalars on ``device``: the rate now and the
        step about to be taken."""
        return (torch.full((), self.get_lr(), dtype=torch.float32,
                           device=device),
                torch.full((), self._step_count + 1, dtype=torch.float32,
                           device=device))

    def _apply_grad_clip(self, params, grads):
        from ..nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                          ClipGradByValue)
        clip = self._grad_clip
        if clip is None:
            return grads
        if isinstance(clip, ClipGradByValue):
            return [torch.clamp(g, clip.min, clip.max) for g in grads]
        if isinstance(clip, ClipGradByNorm):
            out = []
            for g in grads:
                n = torch.sqrt(torch.sum(torch.square(g.to(torch.float32))))
                scale = _scale_of(clip.clip_norm, n)
                out.append((g.to(torch.float32) * scale).to(g.dtype))
            return out
        if isinstance(clip, ClipGradByGlobalNorm):
            scale = _scale_of(clip.clip_norm, _global_norm(grads))
            return [(g.to(torch.float32) * scale).to(g.dtype)
                    for g in grads]
        return grads

    # ---- ZeRO ---------------------------------------------------------------
    _elementwise = True

    def _sharding(self):
        """(the sharding group, its size) under ZeRO, else (None, 1)."""
        if not getattr(self, "_shard_states_axis", None):
            return None, 1
        from ..distributed import collective as C
        group = getattr(self, "_sharding_group", None) or C._default_group()
        return group, (group.nranks if C._pg(group) is not None else 1)

    def _update_param(self, p, g, lr, t):
        """One parameter's rule, in place: whole, or under ZeRO this rank's
        slice and then the all-gather; accumulators staged from host
        memory under ``_offload_states``."""
        group, n = self._sharding()
        d = _shard_dim(p, n) if n > 1 else None
        if d is None:
            part, gpart = p, g
        else:
            if not self._elementwise:
                raise NotImplementedError(
                    f"{type(self).__name__} under ZeRO sharding: its rule "
                    f"reads the whole parameter")
            size = p.shape[d] // n
            part = p.narrow(d, group.rank * size, size).contiguous()
            gpart = g.narrow(d, group.rank * size, size).contiguous()
        accs = self._accs_for(p, like=part)
        offload = getattr(self, "_offload_states", False)
        if offload:
            accs = {k: v.to(p.device, non_blocking=True)
                    for k, v in accs.items()}
        nv, na = self._update_with_master(part, gpart.to(torch.float32),
                                          accs, lr, t)
        if offload:
            na = {k: _to_host(v) for k, v in na.items()}
        self._accumulators[id(p)] = na
        if d is None:
            p.copy_(nv)
            return
        from ..distributed import collective as C
        p.copy_(torch.cat(C.all_gather([], nv.contiguous(), group), dim=d))

    # ---- main entry -------------------------------------------------------
    @torch.no_grad()
    def step(self):
        from ..nn import ClipGradByGlobalNorm
        all_params = [p for p in self._parameters
                      if p.requires_grad and p.grad is not None]
        sparse_params = [p for p in all_params if p.grad.is_sparse]
        params = [p for p in all_params if not p.grad.is_sparse]
        # one global norm over the dense and the sparse gradients
        joint_scale = None
        if sparse_params and params and \
                isinstance(self._grad_clip, ClipGradByGlobalNorm):
            sq = sum(torch.sum(torch.square(p.grad.to(torch.float32)))
                     for p in params)
            sq = sq + sum(torch.sum(torch.square(_merge(p.grad)[1]))
                          for p in sparse_params)
            joint_scale = _scale_of(self._grad_clip.clip_norm,
                                    torch.sqrt(sq))
        if sparse_params:
            if self._sharding()[1] > 1 or getattr(self, "_offload_states",
                                                  False):
                raise NotImplementedError(
                    "a sparse gradient under ZeRO sharding or offload")
            self._sparse_step(sparse_params, scale=joint_scale)
        if not params:
            self._step_count += 1
            return
        grads = [p.grad for p in params]
        if joint_scale is not None:
            grads = [(g.to(torch.float32) * joint_scale).to(g.dtype)
                     for g in grads]
        else:
            grads = self._apply_grad_clip(params, grads)
        scalars = {}
        for p, g in zip(params, grads):
            if p.device not in scalars:
                scalars[p.device] = self._scalars(p.device)
            self._update_param(p, g, *scalars[p.device])
        self._step_count += 1

    def _sparse_step(self, sparse_params, scale=None):
        """The lazy row step of sparse gradients: only the looked-up rows
        of the parameter (its master) and of its row-shaped accumulators
        advance; ``scale`` is the joint global-norm factor when dense
        gradients share the clip."""
        for p in sparse_params:
            lr, t = self._scalars(p.device)
            rows, grad_rows = _merge(p.grad)
            if scale is not None:
                grad_rows = grad_rows * scale
            elif self._grad_clip is not None:
                grad_rows = self._apply_grad_clip([p], [grad_rows])[0]
            accs = self._accs_for(p)
            master = accs.get("_master")
            row_keys = [k for k, a in accs.items()
                        if k != "_master" and isinstance(a, torch.Tensor)
                        and a.dim() >= 1 and a.shape[:1] == p.shape[:1]]
            p_rows = (master[rows] if master is not None
                      else p[rows].to(torch.float32))
            acc_rows = {k: (accs[k][rows] if k in row_keys else accs[k])
                        for k in accs if k != "_master"}
            new_rows, new_accs = self._update(p_rows, grad_rows, acc_rows,
                                              lr, t)
            if master is not None:
                master[rows] = new_rows
            p[rows] = new_rows.to(p.dtype)
            for k, a in new_accs.items():
                if k in row_keys:
                    accs[k][rows] = a
                elif k != "_master":
                    accs[k] = a

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Eager: ``loss.backward()`` then ``step()``. A symbolic loss
        (static mode) appends this optimizer's update to the default main
        program instead, which ``static.Executor.run`` applies after the
        gradients; returns (None, [(param, grad var)])."""
        if getattr(loss, "_symbolic", False):
            from ..static import graph as _sg
            prog = _sg.default_main_program()
            params = parameters or self._parameters or None
            prog._append_opt(self, loss, params)
            return None, _sg.append_backward(loss, params)
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    # ---- state ------------------------------------------------------------
    def state_dict(self) -> dict:
        """{"step": steps taken, "accs_<i>": {name: a copy of the
        accumulator} for the i-th parameter, "LR_Scheduler": the
        scheduler's state}."""
        st = {"step": self._step_count}
        for i, p in enumerate(self._parameters):
            accs = self._accumulators.get(id(p))
            if accs:
                st[f"accs_{i}"] = {k: v.detach().clone()
                                   for k, v in accs.items()}
        if isinstance(self._lr, LRScheduler):
            st["LR_Scheduler"] = self._lr.state_dict()
        return st

    def set_state_dict(self, st: dict):
        self._step_count = st.get("step", 0)
        for i, p in enumerate(self._parameters):
            key = f"accs_{i}"
            if key in st:
                self._accumulators[id(p)] = {
                    k: torch.as_tensor(v, device=p.device).clone()
                    for k, v in st[key].items()}
        if "LR_Scheduler" in st and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(st["LR_Scheduler"])

    @property
    def _learning_rate(self):
        return self._lr


class SGD(Optimizer):
    """~ python/paddle/optimizer/sgd.py."""

    def _update(self, param, grad, accs, lr, t):
        if self._weight_decay:
            grad = grad + self._weight_decay * param.to(torch.float32)
        return param - (lr * grad).to(param.dtype), accs


class Momentum(Optimizer):
    """~ python/paddle/optimizer/momentum.py."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _create_accumulators(self, p):
        return {"velocity": self._zeros(p)}

    def _update(self, param, grad, accs, lr, t):
        if self._weight_decay:
            grad = grad + self._weight_decay * param.to(torch.float32)
        v = self._momentum * accs["velocity"] + grad
        upd = grad + self._momentum * v if self._nesterov else v
        return param - (lr * upd).to(param.dtype), {"velocity": v}


class Adam(Optimizer):
    """~ python/paddle/optimizer/adam.py (``lazy_mode`` is ignored, as in
    the reference)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon

    def _create_accumulators(self, p):
        return {"m": self._zeros(p), "v": self._zeros(p)}

    def _update(self, param, grad, accs, lr, t):
        pf = param.to(torch.float32)
        if self._weight_decay:
            grad = grad + self._weight_decay * pf
        b1, b2 = self._beta1, self._beta2
        m = b1 * accs["m"] + (1 - b1) * grad
        v = b2 * accs["v"] + (1 - b2) * torch.square(grad)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        new_p = pf - lr * (mhat / (torch.sqrt(vhat) + self._eps))
        return new_p.to(param.dtype), {"m": m, "v": v}


class AdamW(Adam):
    """~ python/paddle/optimizer/adamw.py: decoupled decay through
    ``adamw_update``. ``apply_decay_param_fun`` is stored and never read,
    ``lr_ratio`` and ``lazy_mode`` are ignored, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, param, grad, accs, lr, t):
        new_p, m, v = adamw_update(param, grad, accs["m"], accs["v"], t, lr,
                                   self._beta1, self._beta2, self._eps,
                                   self._weight_decay)
        return new_p, {"m": m, "v": v}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _create_accumulators(self, p):
        return {"m": self._zeros(p), "u": self._zeros(p)}

    def _update(self, param, grad, accs, lr, t):
        pf = param.to(torch.float32)
        if self._weight_decay:
            grad = grad + self._weight_decay * pf
        m = self._beta1 * accs["m"] + (1 - self._beta1) * grad
        u = torch.maximum(self._beta2 * accs["u"], torch.abs(grad))
        new_p = pf - (lr / (1 - self._beta1 ** t)) * m / (u + self._eps)
        return new_p.to(param.dtype), {"m": m, "u": u}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _create_accumulators(self, p):
        return {"moment": torch.full(p.shape, self._init_acc,
                                     dtype=torch.float32, device=p.device)}

    def _update(self, param, grad, accs, lr, t):
        pf = param.to(torch.float32)
        if self._weight_decay:
            grad = grad + self._weight_decay * pf
        mom = accs["moment"] + torch.square(grad)
        new_p = pf - lr * grad / (torch.sqrt(mom) + self._eps)
        return new_p.to(param.dtype), {"moment": mom}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, p):
        a = {"mean_square": self._zeros(p), "momentum": self._zeros(p)}
        if self._centered:
            a["mean_grad"] = self._zeros(p)
        return a

    def _update(self, param, grad, accs, lr, t):
        pf = param.to(torch.float32)
        if self._weight_decay:
            grad = grad + self._weight_decay * pf
        ms = self._rho * accs["mean_square"] \
            + (1 - self._rho) * torch.square(grad)
        new_accs = {"mean_square": ms}
        if self._centered:
            mg = self._rho * accs["mean_grad"] + (1 - self._rho) * grad
            denom = torch.sqrt(ms - torch.square(mg) + self._eps)
            new_accs["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = self._momentum * accs["momentum"] + lr * grad / denom
        new_accs["momentum"] = mom
        return (pf - mom).to(param.dtype), new_accs


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._eps = rho, epsilon

    def _create_accumulators(self, p):
        return {"avg_sq_grad": self._zeros(p),
                "avg_sq_update": self._zeros(p)}

    def _update(self, param, grad, accs, lr, t):
        pf = param.to(torch.float32)
        if self._weight_decay:
            grad = grad + self._weight_decay * pf
        asg = self._rho * accs["avg_sq_grad"] \
            + (1 - self._rho) * torch.square(grad)
        upd = (torch.sqrt(accs["avg_sq_update"] + self._eps)
               / torch.sqrt(asg + self._eps)) * grad
        asu = self._rho * accs["avg_sq_update"] \
            + (1 - self._rho) * torch.square(upd)
        return (pf - lr * upd).to(param.dtype), \
            {"avg_sq_grad": asg, "avg_sq_update": asu}


class Lamb(Optimizer):
    """~ python/paddle/optimizer/lamb.py (trust-ratio scaling).
    ``exclude_from_weight_decay_fn`` is ignored, as in the reference."""

    _elementwise = False

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _create_accumulators(self, p):
        return {"m": self._zeros(p), "v": self._zeros(p)}

    def _update(self, param, grad, accs, lr, t):
        pf = param.to(torch.float32)
        b1, b2 = self._beta1, self._beta2
        m = b1 * accs["m"] + (1 - b1) * grad
        v = b2 * accs["v"] + (1 - b2) * torch.square(grad)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._eps) + self._weight_decay * pf
        w_norm = torch.sqrt(torch.sum(torch.square(pf)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return (pf - lr * trust * r).to(param.dtype), {"m": m, "v": v}
