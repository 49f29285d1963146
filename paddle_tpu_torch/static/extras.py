"""``paddle.static``'s other names in the PyTorch port: strategies, EMA,
places, program-state io, host print, the metric helpers, the guards.

Counterpart of ``paddle_tpu/static/extras.py`` (``:20-372``). Program
"serialization" pickles the parameter set, as the reference's does (the
graph itself is re-captured from Python; ``static.io`` writes the
exported program). A ``.pdparams`` is a pickled dict of numpy arrays by
parameter name (``param_name``, else ``param_<i>`` in program order), a
bfloat16 one as ``framework/io.py``'s uint16 record; a ``.pdparams`` the
reference wrote loads here by the same names.
"""
from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch

from ..core import place as _place
from ..core.dtype import convert_dtype, numpy_to_torch
from ..core.tensor import Parameter
from ..framework.io import _host_tensor, _record
from ..ops.dispatch import apply_op
from . import graph as G


class BuildStrategy:
    """~ BuildStrategy (framework/details/build_strategy.h): graph-build
    knobs, recorded (the Executor replays the captured ops either way)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""
        self.enable_sequential_execution = False
        self.fuse_broadcast_ops = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_all_optimizer_ops = False
        self.memory_optimize = None
        self.enable_inplace = False
        self.build_cinn_pass = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """~ ExecutionStrategy: executor scheduling knobs, recorded."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1
        self.use_thread_barrier = True


class ParallelExecutor:
    """~ fluid.ParallelExecutor: the Executor on the default device (one
    device; multi-device programs are ROADMAP item 15)."""

    def __init__(self, use_cuda=None, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None, build_strategy=None,
                 num_trainers=1, trainer_id=0, scope=None):
        from .executor import Executor
        self._program = main_program or G.default_main_program()
        self._exe = Executor()

    def run(self, fetch_list=None, feed=None, feed_dict=None,
            return_numpy=True):
        return self._exe.run(self._program, feed=feed or feed_dict,
                             fetch_list=fetch_list, return_numpy=return_numpy)


class WeightNormParamAttr:
    """~ paddle.static.WeightNormParamAttr (fluid/param_attr.py)."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


class ExponentialMovingAverage:
    """~ paddle.static.ExponentialMovingAverage: shadow = decay * shadow +
    (1 - decay) * param with decay min(decay, (1 + step) / (10 + step)),
    and ``apply()`` / ``restore()`` to swap the shadows in for eval."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._shadow = {}
        self._backup = {}
        self._step = 0

    def update(self, program=None):
        prog = program or G.default_main_program()
        self._step += 1
        decay = min(self._decay, (1 + self._step) / (10 + self._step))
        for p in prog.all_parameters():
            cur = p.detach()
            if id(p) not in self._shadow:
                self._shadow[id(p)] = cur.clone()
            else:
                self._shadow[id(p)] = (decay * self._shadow[id(p)]
                                       + (1 - decay) * cur)

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        prog = G.default_main_program()
        with torch.no_grad():
            for p in prog.all_parameters():
                if id(p) in self._shadow:
                    self._backup[id(p)] = p.detach().clone()
                    p.copy_(self._shadow[id(p)])
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        prog = G.default_main_program()
        with torch.no_grad():
            for p in prog.all_parameters():
                if id(p) in self._backup:
                    p.copy_(self._backup.pop(id(p)))


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """~ paddle.static.Print: identity + a host print of the value (which
    a StaticVar has not: it raises, as the reference's does)."""
    if isinstance(input, G.StaticVar):
        input._no_value()
    vals = input.detach().cpu()
    parts = [message or "Var"]
    if print_tensor_name:
        parts.append(f"name={getattr(input, 'param_name', None)}")
    if print_tensor_shape:
        parts.append(f"shape={list(vals.shape)}")
    if print_tensor_type:
        parts.append(f"dtype={str(vals.dtype).removeprefix('torch.')}")
    parts.append(f"data={vals.reshape(-1)[:summarize].tolist()}")
    print("  ".join(str(p) for p in parts))
    return input


# ---- metric helpers --------------------------------------------------------

def _accuracy(x, y, k):
    topk = torch.argsort(-x, dim=-1, stable=True)[..., :k]
    hit = torch.any(topk == y.reshape(-1, 1), dim=-1)
    return torch.mean(hit.to(torch.float32))


def accuracy(input, label, k=1, correct=None, total=None):
    """~ paddle.static.accuracy: the share of rows whose label is among
    the top ``k`` scores."""
    return apply_op("accuracy", _accuracy, input, label, k=k)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """~ paddle.static.auc: one batch's AUC on the host through
    ``metric.Auc`` (the reference accumulates stat tensors across
    batches)."""
    from ..metric import Auc as _Auc
    m = _Auc(num_thresholds=num_thresholds)
    m.update(input, label)
    val = torch.tensor(np.float32(m.accumulate()))
    zero = torch.zeros(1)
    return val, val.clone(), zero, zero.clone(), zero.clone(), zero.clone()


# ---- places ----------------------------------------------------------------

def cpu_places(device_count=None):
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [_place.CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    ids = device_ids if device_ids is not None else \
        range(torch.cuda.device_count())
    return [_place.CUDAPlace(i) for i in ids]


def _other_places(kind, device_ids):
    """Places of a kind the port has no device of: those asked for."""
    return [_place.Place(kind, i) for i in (device_ids or [])]


def npu_places(device_ids=None):
    return _other_places("npu", device_ids)


def xpu_places(device_ids=None):
    return _other_places("xpu", device_ids)


def mlu_places(device_ids=None):
    return _other_places("mlu", device_ids)


# ---- global vars / parameters ----------------------------------------------

def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    dev = torch.device("cpu") if force_cpu else _place.resolve_device(None)
    v = Parameter(torch.full([int(s) for s in shape], value,
                             dtype=convert_dtype(dtype), device=dev),
                  trainable=False, name=name)
    v.persistable = persistable
    G.default_main_program()._add_param(v)
    return v


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..ops.misc import create_parameter as _cp
    p = _cp(shape, dtype, name=name, attr=attr,
            default_initializer=default_initializer)
    G.default_main_program()._add_param(p)
    return p


# ---- guards ----------------------------------------------------------------

@contextlib.contextmanager
def device_guard(device=None):
    """~ paddle.static.device_guard: ops captured inside it are pinned to
    ``device`` ("cpu", "gpu", "gpu:N") at replay, and tensors made
    eagerly inside it are made there (the default device meanwhile).
    None pins nothing."""
    if device is None:
        yield
        return
    dev = _place.resolve_device(device)
    old_pin, old_default = G._pinned, _place._default
    G._pinned, _place._default = dev, dev
    try:
        yield
    finally:
        G._pinned, _place._default = old_pin, old_default


@contextlib.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    yield


class IpuStrategy:
    """The reference's Graphcore configuration container (config only:
    the port's accelerator is the CUDA card)."""

    def __init__(self):
        self.num_ipus = 1
        self.is_training = True
        self.micro_batch_size = 1
        self.enable_manual_shard = False

    def set_graph_config(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)

    def set_pipelining_config(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class IpuCompiledProgram:
    def __init__(self, program=None, scope=None, ipu_strategy=None):
        raise RuntimeError(
            "IpuCompiledProgram targets Graphcore IPUs; the port replays "
            "programs on the CUDA card through static.Executor")


# ---- program state io ------------------------------------------------------

def _key(p, i):
    return getattr(p, "param_name", None) or f"param_{i}"


def _program_state(program=None):
    prog = program or G.default_main_program()
    out = {}
    for i, p in enumerate(prog.all_parameters()):
        t = p.detach().cpu()
        out[_key(p, i)] = _record(t) if t.dtype == torch.bfloat16 \
            else t.numpy().copy()
    return out


def load_program_state(model_path, var_list=None):
    path = model_path if model_path.endswith(".pdparams") \
        else model_path + ".pdparams"
    with open(path, "rb") as f:
        return pickle.load(f)


def _tensor(v):
    if isinstance(v, dict) and v.get("__tensor__"):
        return _host_tensor(v)
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":   # an ml_dtypes array
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return numpy_to_torch(arr)


def set_program_state(program, state_dict):
    prog = program or G.default_main_program()
    with torch.no_grad():
        for i, p in enumerate(prog.all_parameters()):
            key = _key(p, i)
            if key in state_dict:
                p.copy_(_tensor(state_dict[key]))
    return program


def save(program, model_path, protocol=4):
    """~ paddle.static.save: the program's parameters (+ a manifest)."""
    state = _program_state(program)
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump(state, f, protocol=protocol)
    with open(model_path + ".pdmodel", "wb") as f:
        pickle.dump({"n_params": len(state), "names": list(state)}, f)


def load(program, model_path, executor=None, var_list=None):
    set_program_state(program, load_program_state(model_path))


def serialize_program(feed_vars=None, fetch_vars=None, program=None):
    prog = program or G.default_main_program()
    return pickle.dumps({"names": [_key(p, i) for i, p in
                                   enumerate(prog.all_parameters())],
                         "datas": list(prog._datas)})


def serialize_persistables(feed_vars=None, fetch_vars=None, program=None):
    return pickle.dumps(_program_state(program))


def deserialize_program(data):
    return pickle.loads(data)


def deserialize_persistables(program, data, executor=None):
    set_program_state(program, pickle.loads(data))
    return program


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def normalize_program(program, feed_vars, fetch_vars):
    """~ paddle.static.normalize_program: an inference clone (the captured
    DAG is already the feed -> fetch graph the Executor walks)."""
    return program.clone(for_test=True)
