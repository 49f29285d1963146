"""Automatic mixed precision of the PyTorch port.

Counterpart of ``paddle_tpu/amp/__init__.py``: the reference's op lists
(``WHITE_LIST`` / ``BLACK_LIST``, copied), ``auto_cast`` / ``amp_guard``
with custom lists and levels O1 / O2, ``decorate`` and ``GradScaler``.

The mechanism is the reference's: ``auto_cast`` sets a thread-local state
that the op dispatch (``ops.dispatch.apply_op``) reads; ``_maybe_cast``
casts a white-listed op's float32 inputs to the low dtype (at O2 every op
not black-listed), and a black-listed op's low-dtype inputs to float32.
``torch.autocast`` is not used: its op lists are not the reference's.

``decorate(level="O2")`` casts each model with ``Module.to(dtype)`` (every
floating parameter and buffer, as the reference's ``Layer.to``) and turns
on the optimizers' float32 masters, retrofitting a master for any
low-precision parameter whose accumulators already exist.

``GradScaler`` is the reference's dynamic loss scaling: ``scale`` multiplies
the loss, ``step`` divides every gradient by the scale (``g / scale``),
steps the optimizer unless a gradient is not finite, then ``update``s the
scale (the reference's ``step`` calls ``update`` itself, and so does
``minimize``: a loop must not call it again). The non-finite check reads
the card once per step (one flag over all gradients), where the reference
reads one boolean per parameter; the flag found is the same.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ..core.dtype import convert_dtype
from ..ops import dispatch as _dispatch

# ~ imperative/amp_auto_cast.cc AmpOperators default lists
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "einsum", "linear", "conv1d", "conv2d",
    "conv3d", "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "scaled_dot_product_attention", "addmm",
}
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "cos",
    "sin", "tan", "norm", "cross_entropy", "softmax_with_cross_entropy",
    "bce_with_logits", "binary_cross_entropy", "layer_norm", "rms_norm",
    "batch_norm", "softmax", "log_softmax", "cumsum", "logsumexp", "erf",
    "erfinv", "pow", "mse_loss", "l1_loss", "kl_div",
}

_LOW = (torch.bfloat16, torch.float16)


def amp_state():
    """The active auto_cast state ({level, dtype, white, black}) or
    None."""
    return _dispatch._state.amp


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """~ paddle.amp.auto_cast: ops dispatched inside run with the amp
    casts of ``level`` to ``dtype``; a custom white name leaves the black
    list and a custom black name the white list. ``enable=False`` turns
    amp off inside."""
    st = _dispatch._state
    prev = st.amp
    if not enable:
        new = None
    else:
        white, black = set(WHITE_LIST), set(BLACK_LIST)
        if custom_white_list:
            white |= set(custom_white_list)
            black -= set(custom_white_list)
        if custom_black_list:
            black |= set(custom_black_list)
            white -= set(custom_black_list)
        new = {"level": level, "dtype": convert_dtype(dtype),
               "white": white, "black": black}
    st.amp = new
    try:
        yield
    finally:
        st.amp = prev


amp_guard = auto_cast


def _maybe_cast(op_name: str, vals, st=None):
    """The op's positional arguments with the amp cast of ``st`` (the
    active state when None) applied to its tensors."""
    st = amp_state() if st is None else st
    if st is None:
        return vals
    low = st["dtype"]
    if op_name in st["white"] or st["level"] == "O2" and \
            op_name not in st["black"]:
        return [v.to(low) if isinstance(v, torch.Tensor)
                and v.dtype == torch.float32 else v for v in vals]
    if op_name in st["black"]:
        return [v.to(torch.float32) if isinstance(v, torch.Tensor)
                and v.dtype == low else v for v in vals]
    return vals


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """~ paddle.amp.decorate: O2 casts the models' floating parameters and
    buffers to ``dtype`` and (unless ``master_weight=False``) gives the
    optimizers float32 masters. Returns the models, or (models,
    optimizers) when optimizers are given."""
    single = not isinstance(models, (list, tuple))
    ms = [models] if single else list(models)
    if level == "O2":
        for m in ms:
            m.to(dtype=convert_dtype(dtype))
    if optimizers is None:
        return models if single else ms
    if level == "O2" and master_weight is not False:
        opts = (optimizers if isinstance(optimizers, (list, tuple))
                else [optimizers])
        for o in opts:
            o._multi_precision = True
            # masters for accumulators made before decorate (a step taken
            # before, or a set_state_dict): _accs_for keeps what it has
            for p in getattr(o, "_parameters", []):
                accs = o._accumulators.get(id(p))
                if accs is not None and "_master" not in accs and \
                        p.dtype in _LOW:
                    accs["_master"] = p.detach().to(torch.float32)
    return (models, optimizers)


class GradScaler:
    """~ paddle.amp.GradScaler: dynamic loss scaling (module docstring)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def _unscale_and_check(self, optimizer):
        flags = []
        for p in optimizer._parameters:
            if p.grad is not None:
                if p.grad.is_sparse:
                    p.grad = p.grad / self._scale
                    vals = p.grad.coalesce().values()
                else:
                    vals = p.grad.div_(self._scale)
                flags.append(torch.isfinite(vals).all())
        # one read of the card for all the gradients
        self._found_inf = bool(flags) and not bool(torch.stack(flags).all())
        return self._found_inf

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        found = self._unscale_and_check(optimizer)
        if not found:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad += 1
            self._good = 0
            if self._bad >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good = 0

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return torch.tensor(self._scale)

    def state_dict(self):
        return {"scale": self._scale, "incr_count": self._good,
                "decr_count": self._bad}

    def load_state_dict(self, st):
        self._scale = st.get("scale", self._scale)
        self._good = st.get("incr_count", 0)
        self._bad = st.get("decr_count", 0)
