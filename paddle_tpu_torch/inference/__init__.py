"""Inference deployment of the PyTorch port.

Counterpart of ``paddle_tpu/inference/__init__.py``
(~ paddle/fluid/inference/ AnalysisPredictor, analysis_predictor.h:93):
load the exported artifact, run it with zero-copy tensors. The artifact
is ``jit.save``'s ``.pdexport`` (a ``torch.export`` program, weights
frozen in); ``Predictor`` runs it through ``jit.load``'s
``TranslatedLayer``. Per-thread clones and ``PredictorPool`` share the
loaded program and its weights (the same storage; the reference shares
them via Scope, analysis_predictor.h Clone). The TensorRT / Lite / ONNX
engine slots are absent, as in the reference.

The device: ``Config`` takes the port's default device (``cuda`` unless
``set_device("cpu")``) and ``disable_gpu()`` makes it the CPU. The
reference picks the TPU when it finds one and the CPU otherwise
(``:44-45``); the port never falls back: a ``Config`` or predictor on the
card raises where there is no CUDA. A predictor's outputs come back as
numpy arrays (``copy_to_cpu``), a bfloat16 one as float32 (exact: numpy
has no bfloat16); with ``enable_memory_optim`` they stay tensors on the
device until ``copy_to_cpu``.

Kept as the reference has them (ROADMAP Queue 3):
``get_output_names()`` is ``["out0"]`` before the first ``run``; a handle
name without digits maps to index 0.

``DynamicBatcher`` gathers concurrent requests into one predictor run,
padded to a power-of-two bucket (the reference's ``:301``, ``:307-356``);
``BatchingConfig`` is the admission config it shares with
``serving.ServingEngine``.
"""
from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.place import resolve_device
from ..jit import load as _jit_load

__all__ = ["Config", "Predictor", "PredictorPool", "DynamicBatcher",
           "BatchingConfig", "create_predictor", "get_version"]


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "inference: the predictor runs on the card and this machine "
            "has no CUDA; call Config.disable_gpu() for the CPU")


class Config:
    """~ paddle_infer.Config (inference/api/paddle_analysis_config.h).

    Device selection is honored; the graph-level IR toggles are recorded
    (the artifact was captured once at export) so ``summary()`` reports
    them."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        self.model_path = model_path
        self.params_path = params_path
        self._threads = 1
        self._device = resolve_device()     # raises without the card
        self._memory_optim = False
        self._ir_optim = True
        self._glog = True
        self._profile = False

    # -- devices ---------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = torch.device("cuda", device_id)

    def disable_gpu(self):
        self._device = torch.device("cpu")

    def use_gpu(self):
        return self._device.type != "cpu"

    # -- execution -------------------------------------------------------
    def set_cpu_math_library_num_threads(self, n):
        self._threads = int(n)

    def cpu_math_library_num_threads(self):
        return self._threads

    def enable_memory_optim(self, flag=True):
        self._memory_optim = bool(flag)

    def memory_optim_enabled(self):
        return self._memory_optim

    def switch_ir_optim(self, flag=True):
        self._ir_optim = bool(flag)

    def ir_optim(self):
        return self._ir_optim

    def disable_glog_info(self):
        self._glog = False

    def glog_info_disabled(self):
        return not self._glog

    def enable_profile(self):
        self._profile = True

    def summary(self) -> str:
        rows = [("model_path", self.model_path),
                ("device", self._device),
                ("cpu_math_threads", self._threads),
                ("memory_optim", self._memory_optim),
                ("ir_optim (captured at export)", self._ir_optim),
                ("profile", self._profile)]
        w = max(len(k) for k, _ in rows)
        return "\n".join(f"{k.ljust(w)}  {v}" for k, v in rows)


def _host(t) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


class Predictor:
    """~ paddle_infer.Predictor over a jit.save artifact."""

    def __init__(self, config_or_path, _shared=None):
        self._config = (config_or_path
                        if isinstance(config_or_path, Config) else None)
        self._device = (self._config._device if self._config is not None
                        else resolve_device())
        if self._device.type == "cuda":
            _require_cuda()
        if _shared is not None:
            # clone: share program + weights, private IO buffers
            self._layer = _shared
        else:
            path = (config_or_path.model_path
                    if isinstance(config_or_path, Config) else config_or_path)
            if path.endswith(".pdmodel") or path.endswith(".pdiparams"):
                path = path.rsplit(".", 1)[0]
            self._layer = _jit_load(path)
        self._inputs: List = []
        self._outputs: List = []
        self._lock = threading.Lock()

    # -- signature -------------------------------------------------------
    def _n_inputs(self) -> int:
        ep = self._layer.program
        if ep is not None:
            return sum(1 for s in ep.graph_signature.input_specs
                       if s.kind == torch.export.graph_signature
                       .InputKind.USER_INPUT)
        return 8

    def get_input_names(self):
        return [f"x{i}" for i in range(self._n_inputs())]

    def get_input_handle(self, name):
        idx = int(name[1:]) if name[1:].isdigit() else 0
        return _IOHandle(self, idx)

    def get_output_names(self):
        return [f"out{i}" for i in range(len(self._outputs) or 1)]

    def get_output_handle(self, name):
        return _OutHandle(self, int(name[3:]) if name[3:].isdigit() else 0)

    # -- execution -------------------------------------------------------
    def _tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self._device)
        return torch.as_tensor(np.asarray(x), device=self._device)

    def run(self, inputs: Optional[List] = None):
        if inputs is not None:
            self._inputs = list(inputs)
        xs = [self._tensor(x) for x in self._inputs]
        with self._lock:
            outs = self._layer(*xs)
        if not isinstance(outs, (tuple, list)):
            outs = [outs]
        if self._config is not None and self._config.memory_optim_enabled():
            # keep device tensors; host copy deferred to copy_to_cpu
            self._outputs = list(outs)
        else:
            self._outputs = [_host(o) for o in outs]
        return [_host(o) if isinstance(o, torch.Tensor) else o
                for o in self._outputs]

    def clone(self) -> "Predictor":
        """Program/weight-sharing clone for per-thread serving
        (~ AnalysisPredictor::Clone sharing the Scope)."""
        return Predictor(self._config or "", _shared=self._layer)

    def try_shrink_memory(self):
        gc.collect()
        if self._device.type == "cuda":
            torch.cuda.empty_cache()


class _IOHandle:
    """Input handle; holds the array until run() (a device tensor passed
    via share_external_data stays where it is)."""

    def __init__(self, pred, idx):
        self.pred = pred
        self.idx = idx
        self._shape = None

    def _store(self, arr):
        while len(self.pred._inputs) <= self.idx:
            self.pred._inputs.append(None)
        self.pred._inputs[self.idx] = arr

    def copy_from_cpu(self, arr):
        a = np.asarray(arr)
        if self._shape is not None:
            a = a.reshape(self._shape)
        self._store(a)

    def share_external_data(self, arr):
        self._store(arr)

    def reshape(self, shape):
        self._shape = tuple(shape)


class _OutHandle:
    def __init__(self, pred, idx):
        self.pred = pred
        self.idx = idx

    def copy_to_cpu(self):
        o = self.pred._outputs[self.idx]
        return _host(o) if isinstance(o, torch.Tensor) else np.asarray(o)

    def shape(self):
        return tuple(self.pred._outputs[self.idx].shape)


class PredictorPool:
    """~ paddle_infer::services::PredictorPool — one loaded artifact,
    N program- and weight-sharing clones for worker threads."""

    def __init__(self, config: Config, size: int = 1):
        self._main = Predictor(config)
        self._preds = [self._main] + [self._main.clone()
                                      for _ in range(max(0, size - 1))]

    def retrieve(self, idx: int) -> Predictor:
        return self._preds[idx]

    def __len__(self):
        return len(self._preds)


@dataclasses.dataclass
class BatchingConfig:
    """The request-coalescing knobs shared by both batchers: how many
    requests one flush may gather (``max_batch``) and how long the
    oldest waiting request may sit before a partial batch flushes
    anyway (``max_delay_ms``).

    ``DynamicBatcher`` (request/response predictors) and the
    continuous-batching ``paddle_tpu_torch.serving.ServingEngine`` (token
    streams) both take this as their admission config.
    """

    max_batch: int = 32
    max_delay_ms: float = 2.0

    @property
    def max_delay(self) -> float:
        """max_delay_ms in seconds (the unit the wait loops use)."""
        return self.max_delay_ms / 1e3


class DynamicBatcher:
    """Serving-side request coalescing (~ the reference serving stack's
    request batching in front of AnalysisPredictor).

    Concurrent ``infer()`` calls gather into ONE batch executed on a
    single Predictor call. Gathered batches PAD UP to power-of-two
    buckets (<= max_batch; the pad rows repeat the last row) to keep the
    set of batch shapes logarithmic, as the reference does for its
    compiled shapes. Results are split back per request; padding rows
    are dropped. A lone request never waits past ``max_delay_ms``: the
    flush timer fires and it rides a batch of one.
    """

    def __init__(self, predictor: Predictor, max_batch: int | None = None,
                 max_delay_ms: float | None = None,
                 config: BatchingConfig | None = None):
        config = config or BatchingConfig()
        if max_batch is not None:
            config = dataclasses.replace(config, max_batch=max_batch)
        if max_delay_ms is not None:
            config = dataclasses.replace(config,
                                         max_delay_ms=max_delay_ms)
        self.predictor = predictor
        self.config = config
        self.max_batch = config.max_batch
        self.max_delay = config.max_delay
        self._pending: List = []
        self._cv = threading.Condition()
        self._stopped = False
        self._runs = 0  # underlying predictor.run calls (telemetry/tests)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def infer(self, inputs: List) -> List[np.ndarray]:
        """Submit one request (list of arrays, leading dim = this
        request's rows); blocks until its slice of the batched result is
        ready."""
        arrs = [_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)
                for x in inputs]
        done = threading.Event()
        # signature groups batch assembly: only shape/dtype-compatible
        # requests coalesce, so one malformed request can't poison the
        # valid requests that happened to land in the same window
        sig = tuple((a.shape[1:], str(a.dtype)) for a in arrs)
        slot = {"inputs": arrs, "rows": arrs[0].shape[0], "sig": sig,
                "done": done, "out": None, "err": None}
        with self._cv:
            if self._stopped:
                raise RuntimeError("DynamicBatcher is shut down")
            self._pending.append(slot)
            self._cv.notify_all()
        done.wait()
        if slot["err"] is not None:
            raise slot["err"]
        return slot["out"]

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, max(cap, n))

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._pending:
                    return
                deadline = time.perf_counter() + self.max_delay
                while (sum(s["rows"] for s in self._pending) < self.max_batch
                       and not self._stopped):
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                sig = self._pending[0]["sig"]
                batch, taken, rest = [], 0, []
                for s in self._pending:
                    if s["sig"] == sig and (
                            not batch
                            or taken + s["rows"] <= self.max_batch):
                        # the first request is always taken (even if its
                        # own rows exceed max_batch); later ones only
                        # while the budget holds
                        batch.append(s)
                        taken += s["rows"]
                    else:
                        rest.append(s)
                self._pending = rest
            try:
                n_in = len(batch[0]["inputs"])
                cat = [np.concatenate([s["inputs"][i] for s in batch])
                       for i in range(n_in)]
                rows = cat[0].shape[0]
                padded = self._bucket(rows, self.max_batch)
                if padded > rows:
                    cat = [np.concatenate(
                        [c, np.repeat(c[-1:], padded - rows, axis=0)])
                        for c in cat]
                outs = self.predictor.run(cat)
                self._runs += 1
                off = 0
                for s in batch:
                    s["out"] = [o[off:off + s["rows"]] for o in outs]
                    off += s["rows"]
            except Exception as e:  # noqa: BLE001 — delivered per request
                for s in batch:
                    s["err"] = e
            for s in batch:
                s["done"].set()

    def shutdown(self):
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=10)


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def get_version() -> str:
    from .. import __version__
    return __version__
