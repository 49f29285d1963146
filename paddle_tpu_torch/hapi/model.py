"""hapi's ``Model`` of the PyTorch port: ``fit`` / ``evaluate`` /
``predict`` / ``save`` / ``load``, with ``summary`` and ``flops``.

Counterpart of ``paddle_tpu/hapi/model.py``: ``Model`` (``:138-352``, the
reference's dynamic-graph path), ``summary_layer`` / ``summary``
(``:354-377``) and ``flops`` (``:379-439``). The network runs eagerly
where its parameters are (the card unless the caller put it on the CPU);
the batches come from the port's ``io.DataLoader`` on the default device;
a batch given as numpy to ``train_batch`` / ``eval_batch`` /
``predict_batch`` is made a tensor there by ``to_tensor``. Each training
step reads its loss on the host (``float``) and updates the metrics on the
host, as the reference's (``:178-182``).

``StaticGraphAdapter`` (the reference's static-graph adapter,
``:31-136``) is refused by name: static graphs are ROADMAP Queue 1 item
14. The port has no static mode (``enable_static`` raises), so ``Model``
never reaches it.

Kept as the reference has them (ROADMAP Queue 3): ``prepare`` never
reads ``amp_configs`` (call ``amp.decorate`` first); ``fit`` never reads
``accumulate_grad_batches`` and always appends an ``LRScheduler()``
callback; ``evaluate`` and ``predict`` never read ``callbacks``,
``verbose``, ``log_freq`` or ``num_samples``; ``train_batch(update=False)``
leaves the gradients to accumulate; ``summary`` ignores ``input_size``;
``flops`` feeds float32 zeros and, after its forward, sets ``training``
back on the network itself only (its sublayers stay in eval mode).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..core.tensor import to_tensor
from ..io import DataLoader
from ..metric import Metric


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _as_tensors(xs):
    return [to_tensor(x) if isinstance(x, np.ndarray) else x for x in xs]


def _host(out):
    """A tensor -> numpy on the host (bfloat16 as float32); other values
    unchanged."""
    if isinstance(out, torch.Tensor):
        out = out.detach()
        if out.dtype == torch.bfloat16:
            out = out.to(torch.float32)
        return out.cpu().numpy()
    return out


class StaticGraphAdapter:
    """The reference's static-graph adapter: not ported."""

    def __init__(self, model=None):
        raise NotImplementedError(
            "hapi's StaticGraphAdapter (a Model over static Programs) is "
            "not ported yet: ROADMAP Queue 1 item 14")


class Model:
    """``paddle.Model``: a network with a keras-style trainer."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._input_specs = _to_list(inputs)
        self._label_specs = _to_list(labels)

    # -- setup --------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        return self

    # -- single-batch ops ---------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One step: forward, loss, backward, (``update``) the optimizer's
        step and ``clear_grad``, then the metrics. Returns ([loss],
        [metric values]) or [loss]."""
        self.network.train()
        inputs = _as_tensors(_to_list(inputs))
        labels = _as_tensors(_to_list(labels))
        outputs = self.network(*inputs)
        losses = self._loss(*(_to_list(outputs) + labels))
        losses.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = []
        for m in self._metrics:
            m.update(*_to_list(m.compute(*(_to_list(outputs) + labels))))
            metrics.append(m.accumulate())
        loss = [float(losses.detach())]
        return (loss, metrics) if metrics else loss

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = _as_tensors(_to_list(inputs))
        labels = _as_tensors(_to_list(labels))
        outputs = self.network(*inputs)
        metrics = []
        loss_v = None
        if self._loss is not None and labels:
            loss_v = [float(self._loss(*(_to_list(outputs) + labels)))]
        for m in self._metrics:
            m.update(*_to_list(m.compute(*(_to_list(outputs) + labels))))
            metrics.append(m.accumulate())
        return (loss_v, metrics) if loss_v is not None else metrics

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        return self.network(*_as_tensors(_to_list(inputs)))

    # -- loops --------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        from .callbacks import CallbackList, LRScheduler, ProgBarLogger

        train_loader = train_data if isinstance(train_data, DataLoader) \
            else DataLoader(train_data, batch_size=batch_size,
                            shuffle=shuffle, drop_last=drop_last,
                            num_workers=num_workers)
        eval_loader = None
        if eval_data is not None:
            eval_loader = eval_data if isinstance(eval_data, DataLoader) \
                else DataLoader(eval_data, batch_size=batch_size,
                                num_workers=num_workers)

        cbs = _to_list(callbacks)
        if verbose:
            cbs = [ProgBarLogger(log_freq, verbose=verbose)] + cbs
        cbs.append(LRScheduler())
        cb = CallbackList(cbs)
        cb.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cb.set_params({"epochs": epochs, "steps": steps, "verbose": verbose})

        self.stop_training = False
        cb.on_train_begin()
        it_count = 0
        for epoch in range(epochs):
            cb.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, data in enumerate(train_loader):
                cb.on_train_batch_begin(step)
                inputs, labels = self._split_data(data)
                res = self.train_batch(inputs, labels)
                logs = self._pack_logs(res)
                cb.on_train_batch_end(step, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    self.stop_training = True
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0,
                                          _callbacks=cb)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cb.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, str(epoch)))
            if self.stop_training:
                break
        cb.on_train_end()
        if save_dir:
            self.save(os.path.join(save_dir, "final"))

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None,
                 _callbacks=None):
        loader = eval_data if isinstance(eval_data, DataLoader) \
            else DataLoader(eval_data, batch_size=batch_size,
                            num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        cb = _callbacks
        if cb:
            cb.on_eval_begin()
        losses = []
        for data in loader:
            inputs, labels = self._split_data(data)
            res = self.eval_batch(inputs, labels)
            if isinstance(res, tuple):
                losses.append(res[0][0])
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        if cb:
            cb.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """[the batches' outputs as numpy (bfloat16 as float32)], or
        [their concatenation] with ``stack_outputs``."""
        loader = test_data if isinstance(test_data, DataLoader) \
            else DataLoader(test_data, batch_size=batch_size,
                            num_workers=num_workers)
        outputs = []
        for data in loader:
            inputs, _ = self._split_data(data)
            outputs.append(_host(self.predict_batch(inputs)))
        if stack_outputs:
            return [np.concatenate(outputs)]
        return [outputs]

    # -- persistence --------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams``: the network's state dict; with ``training``,
        ``path.pdopt``: the optimizer's (``paddle.save``)."""
        from ..framework.io import save as _save
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as _load
        self.network.set_state_dict(_load(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt"))

    def parameters(self):
        return self.network.parameters()

    # -- helpers ------------------------------------------------------------
    def _split_data(self, data, has_labels=True):
        if isinstance(data, (list, tuple)):
            data = list(data)
            if has_labels and len(data) >= 2:
                return data[:-1], data[-1:]
            return data, []
        return [data], []

    def _pack_logs(self, res):
        logs = {}
        if isinstance(res, tuple):
            loss, metrics = res
            logs["loss"] = loss[0]
            for m, v in zip(self._metrics, metrics):
                logs[m.name()] = v
        else:
            logs["loss"] = res[0]
        return logs

    def summary(self, input_size=None, dtype=None):
        return summary_layer(self.network)


def summary_layer(network):
    """Print a table of the network's parameters (name, shape, count);
    returns {"total_params", "trainable_params"}."""
    rows = []
    total = 0
    trainable = 0
    for name, p in network.named_parameters():
        n = p.numel()
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = [f"{'Param':{width}s} {'Shape':24s} {'Count':>12s}"]
    for name, shape, n in rows:
        lines.append(f"{name:{width}s} {str(shape):24s} {n:12d}")
    lines.append("-" * (width + 38))
    lines.append(f"Total params: {total:,} (trainable {trainable:,})")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def summary(net, input_size=None, dtypes=None):
    return summary_layer(net)


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The reference's forward-hook count: one forward of zeros of
    ``input_size`` (float32, on the device of the network's parameters),
    then per layer type: a convolution out elements x prod(weight.shape[1:]),
    a linear layer rows x prod(weight.shape), a norm 2 x input elements, a
    pool output elements, an embedding 0; ``custom_ops`` {layer type:
    fn(layer, x, out)} overrides. Returns the total."""
    counts = {}
    handles = []

    def make_hook(name):
        def hook(layer, inputs, outputs):
            x = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
            out = outputs[0] if isinstance(outputs, (tuple, list)) \
                else outputs
            f = 0
            tname = type(layer).__name__
            if custom_ops and type(layer) in custom_ops:
                f = custom_ops[type(layer)](layer, x, out)
            elif getattr(layer, "weight", None) is not None:
                w = layer.weight
                if "Conv" in tname:
                    f = int(np.prod(out.shape)) * int(np.prod(w.shape[1:]))
                elif "Linear" in tname:
                    f = int(np.prod(x.shape[:-1])) * int(np.prod(w.shape))
                elif "Norm" in tname:
                    f = int(np.prod(x.shape)) * 2
            elif "Pool" in tname:
                f = int(np.prod(out.shape))
            if f:
                counts[name] = counts.get(name, 0) + f
        return hook

    for name, lyr in net.named_sublayers(include_self=True):
        handles.append(lyr.register_forward_post_hook(
            make_hook(name or "net")))
    try:
        first = next(iter(net.parameters()), None)
        device = first.device if first is not None else None
        x = to_tensor(np.zeros(tuple(input_size), dtype="float32"),
                      place=device)
        was_training = net.training
        net.eval()
        with torch.no_grad():
            net(x)
        net.training = was_training
    finally:
        for h in handles:
            h.remove()
    total = sum(counts.values())
    if print_detail:
        for k, v in counts.items():
            print(f"{k:40s} {v:15,d}")
        print(f"Total FLOPs: {total:,}")
    return total
