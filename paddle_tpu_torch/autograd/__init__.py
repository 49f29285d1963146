"""Autograd of the PyTorch port, on torch's own.

Counterpart of ``paddle_tpu/autograd/{__init__,tape,py_layer}.py``: the
reference's define-by-run tape is torch's autograd here, so what stays is
its API and its behaviours:

* ``grad(outputs, inputs, grad_outputs, retain_graph, create_graph,
  only_inputs, allow_unused)``: ``torch.autograd.grad``, leaving every
  ``.grad`` alone, with the reference's RuntimeError for an input the
  graph does not reach (unless ``allow_unused``, which gives None). The
  reference's tape never builds a second-order graph (its pullbacks move
  raw arrays), so ``create_graph`` is accepted and ignored here too: the
  gradients carry no graph. ``retain_graph`` None is False, as there.
* ``backward(tensors, grad_tensors, retain_graph)``;
* ``no_grad``, ``enable_grad``, ``grad_enabled``, ``set_grad_enabled``
  (torch's, usable as context managers and decorators);
* ``register_post_backward_hook(fn)``: ``fn()`` runs after each
  ``backward`` and ``grad`` of this module, as the reference's run after
  every tape backward. ``Tensor.backward`` is torch's own method and does
  not run them;
* ``PyLayer`` / ``PyLayerContext`` / ``LegacyPyLayer`` (``py_layer``).
"""
from __future__ import annotations

import torch

from .py_layer import LegacyPyLayer, PyLayer, PyLayerContext  # noqa: F401

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
grad_enabled = torch.is_grad_enabled

_post_backward_hooks: dict = {}
_hook_counter = [0]


def _as_list(x):
    return [x] if isinstance(x, torch.Tensor) else x


def _run_hooks():
    for hook in list(_post_backward_hooks.values()):
        hook()


def backward(tensors, grad_tensors=None, retain_graph: bool = False):
    """Accumulate the gradients of ``tensors`` (seeded by
    ``grad_tensors``, ones for a scalar) into the leaves' ``.grad``, then
    run the post-backward hooks."""
    torch.autograd.backward(_as_list(tensors),
                            None if grad_tensors is None
                            else _as_list(grad_tensors),
                            retain_graph=retain_graph)
    _run_hooks()


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """The gradients of ``outputs`` with respect to ``inputs`` (a list,
    in their order), without touching any ``.grad``."""
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    if grad_outputs is not None:
        grad_outputs = _as_list(grad_outputs)
    grads = torch.autograd.grad(outputs, inputs, grad_outputs,
                                retain_graph=bool(retain_graph),
                                allow_unused=True)
    _run_hooks()
    results = []
    for i, g in enumerate(grads):
        if g is None and not allow_unused:
            raise RuntimeError(
                f"input {i} was not used in the graph (pass "
                "allow_unused=True to return None)")
        results.append(g)
    return results


def register_post_backward_hook(fn):
    """Run ``fn()`` after every ``backward`` / ``grad`` of this module.
    Returns a handle with ``.remove()``."""
    _hook_counter[0] += 1
    hid = _hook_counter[0]
    _post_backward_hooks[hid] = fn

    class _Handle:
        def remove(self):
            _post_backward_hooks.pop(hid, None)

    return _Handle()
