"""The training callbacks of the PyTorch port.

Counterpart of ``paddle_tpu/hapi/callbacks.py``, in plain Python as the
reference: ``Callback``, ``CallbackList``, ``ProgBarLogger``,
``ModelCheckpoint``, ``LRScheduler`` (steps the optimizer's scheduler),
``EarlyStopping`` (watches the evaluation's logs), ``VisualDL`` (one JSON
line per training step) and ``ReduceLROnPlateau`` (watches the epoch's
logs). Kept as the reference has them (ROADMAP Queue 3):
``ReduceLROnPlateau`` lowers the rate through ``optimizer.set_lr``, which
raises RuntimeError when the rate is a scheduler; ``ModelCheckpoint``
saves at epochs where ``epoch % save_freq == 0`` (the first epoch
included) and again as "final".
"""
from __future__ import annotations

import json
import os
import time

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """A text line per epoch and every ``log_freq`` training steps."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {_fmt(v)}"
                               for k, v in (logs or {}).items())
            print(f"step {step + 1}/{self.steps or '?'} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            items = " - ".join(f"{k}: {_fmt(v)}"
                               for k, v in (logs or {}).items())
            print(f"epoch {epoch + 1} done in {dt:.1f}s - {items}")


def _fmt(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return "[" + ", ".join(f"{float(x):.4f}" for x in np.ravel(v)) + "]"
    try:
        return f"{float(v):.4f}"
    except (TypeError, ValueError):
        return str(v)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, f"{epoch}"))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's scheduler (if its rate is one) after each
    training step (``by_step``) and / or each epoch (``by_epoch``)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


class EarlyStopping(Callback):
    """Sets ``model.stop_training`` once the evaluation's ``monitor`` has
    not improved by ``min_delta`` for ``patience`` evaluations."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.verbose = verbose
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(np.ravel(cur)[0])
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"early stopping (best {self.monitor}="
                          f"{self.best:.5f})")


class VisualDL(Callback):
    """Appends one JSON line per training step (the step and the logs'
    numbers) to ``log_dir/metrics.jsonl``."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        rec = {"step": self._step}
        for k, v in (logs or {}).items():
            try:
                rec[k] = float(np.ravel(v)[0])
            except (TypeError, ValueError):
                pass
        self._f.write(json.dumps(rec) + "\n")

    def on_train_end(self, logs=None):
        self._f.close()


class ReduceLROnPlateau(Callback):
    """Multiplies the rate by ``factor`` (not below ``min_lr``) once the
    epoch's ``monitor`` has not improved by ``min_delta`` for
    ``patience`` epochs."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.mode = mode
        self._best = None
        self._wait = 0
        self._cooldown_counter = 0

    def _better(self, cur):
        if self._best is None:
            return True
        if self.mode == "max" or (self.mode == "auto"
                                  and "acc" in self.monitor):
            return cur > self._best + self.min_delta
        return cur < self._best - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._cooldown_counter > 0:
            self._cooldown_counter -= 1
            self._wait = 0
        if self._better(cur):
            self._best = cur
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                lr = max(float(opt.get_lr()) * self.factor, self.min_lr)
                opt.set_lr(lr)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr -> {lr:.3e}")
            self._cooldown_counter = self.cooldown
            self._wait = 0
