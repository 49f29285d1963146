"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX
package, its entry points run on CUDA unless the caller asks for the CPU,
and ``chip_smoke.py`` refuses to run without a card or without the rest of
the repository."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(len(names), bad)
assert not bad, bad
for name in ("paddle_tpu_torch.ops.flash_attention",
             "paddle_tpu_torch.ops.flash_attention_gqa",
             "paddle_tpu_torch.ops.splash_attention",
             "paddle_tpu_torch.ops.fused_ce",
             "paddle_tpu_torch.ops.chunked_ce",
             "paddle_tpu_torch.examples.train_llama_long_context",
             "paddle_tpu_torch.models.nlp.train_utils",
             "paddle_tpu_torch.examples.train_llama_compiled",
             "paddle_tpu_torch.ops.layer_norm",
             "paddle_tpu_torch.ops.dropout_ln",
             "paddle_tpu_torch.core.generator",
             "paddle_tpu_torch.nn.functional.attention",
             "paddle_tpu_torch.nn.layer.transformer",
             "paddle_tpu_torch.nn.functional.loss",
             "paddle_tpu_torch.models.nlp.bert",
             "paddle_tpu_torch.models.nlp.gpt",
             "paddle_tpu_torch.ops.linalg",
             "paddle_tpu_torch.models.nlp.moe",
             "paddle_tpu_torch.incubate.distributed.models.moe",
             "paddle_tpu_torch.examples.train_moe",
             "paddle_tpu_torch.incubate.nn",
             "paddle_tpu_torch.nn.functional.conv",
             "paddle_tpu_torch.nn.functional.pooling",
             "paddle_tpu_torch.nn.functional.norm",
             "paddle_tpu_torch.nn.layer.conv",
             "paddle_tpu_torch.nn.layer.pooling",
             "paddle_tpu_torch.nn.layer.activation",
             "paddle_tpu_torch.ops.manipulation",
             "paddle_tpu_torch.vision.datasets",
             "paddle_tpu_torch.vision.models.lenet",
             "paddle_tpu_torch.vision.models.resnet",
             "paddle_tpu_torch.inference",
             "paddle_tpu_torch.obs", "paddle_tpu_torch.obs.slo",
             "paddle_tpu_torch.obs.trace", "paddle_tpu_torch.obs.metrics",
             "paddle_tpu_torch.obs.ledger", "paddle_tpu_torch.obs.flight",
             "paddle_tpu_torch.serving", "paddle_tpu_torch.serving.workload",
             "paddle_tpu_torch.serving.metrics",
             "paddle_tpu_torch.serving.scheduler",
             "paddle_tpu_torch.serving.sim",
             "paddle_tpu_torch.serving.adapters",
             "paddle_tpu_torch.serving.grammar",
             "paddle_tpu_torch.serving.hostmem",
             "paddle_tpu_torch.serving.engine",
             "paddle_tpu_torch.serving.cluster",
             "paddle_tpu_torch.serving.autoscale",
             "paddle_tpu_torch.serving.faults",
             "paddle_tpu_torch.quantization",
             "paddle_tpu_torch.quantization.int8",
             "paddle_tpu_torch.core.flags", "paddle_tpu_torch.ops.dispatch",
             "paddle_tpu_torch.amp", "paddle_tpu_torch.autograd",
             "paddle_tpu_torch.autograd.py_layer",
             "paddle_tpu_torch.regularizer", "paddle_tpu_torch.optimizer",
             "paddle_tpu_torch.optimizer.lr",
             "paddle_tpu_torch.optimizer.optimizer",
             "paddle_tpu_torch.nn.initializer",
             "paddle_tpu_torch.nn.layer.loss",
             "paddle_tpu_torch.core.tensor", "paddle_tpu_torch.ops.creation",
             "paddle_tpu_torch.ops.math", "paddle_tpu_torch.ops.codegen",
             "paddle_tpu_torch.ops.control_flow",
             "paddle_tpu_torch.ops.tensor_methods",
             "paddle_tpu_torch.tensor", "paddle_tpu_torch.nn.layer.rnn",
             "paddle_tpu_torch.fft", "paddle_tpu_torch.io",
             "paddle_tpu_torch.io.shm_channel",
             "paddle_tpu_torch.io.native_loader",
             "paddle_tpu_torch.utils.native", "paddle_tpu_torch.framework",
             "paddle_tpu_torch.framework.io",
             "paddle_tpu_torch.framework.device",
             "paddle_tpu_torch.framework.custom_device",
             "paddle_tpu_torch.metric", "paddle_tpu_torch.hapi",
             "paddle_tpu_torch.hapi.model", "paddle_tpu_torch.hapi.callbacks",
             "paddle_tpu_torch.callbacks", "paddle_tpu_torch.ops.autotune"):
    assert name in names, name
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = _run(["-c", _IMPORT_ALL], ROOT)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 16          # every module of the slices was imported


# a module looked up or imported by name: sys.modules[...] / .get(...),
# importlib.import_module(...), __import__(...)
_LOOKUP = re.compile(r"(sys\.modules(\.get)?[\[(]|import_module\(|"
                     r"__import__\()\s*[\"']([\w.]+)")


def test_port_names_no_jax_module_in_a_lookup():
    """No module of the port, and not chip_smoke.py, reaches JAX or the
    JAX package by name (which the import check above cannot see until
    the line runs)."""
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = []
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            for m in _LOOKUP.finditer(line):
                if m.group(3).split(".")[0] in ("jax", "jaxlib",
                                                "paddle_tpu"):
                    bad.append(f"{f.relative_to(ROOT)}:{n}: {line.strip()}")
    assert len(files) > 60 and not bad, bad


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_entry_points_refuse_a_missing_card():
    """Without CUDA, a default or "cuda" device raises; "cpu" runs."""
    _needs_no_card()
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.examples.train_llama_compiled import train
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    from paddle_tpu_torch.nn import LayerNorm, Linear
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             MoEConfig, MoEForCausalLM,
                                             llama_paged_decode_factory,
                                             llama_train_step_factory,
                                             moe_train_step_factory)
    from paddle_tpu_torch.ops import PagedKVCache

    cfg = LlamaConfig.tiny(vocab=32, hidden=16, layers=1, heads=2,
                           kv_heads=1)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LlamaForCausalLM(cfg, device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PagedKVCache(4, 4, 1, 8, device=device)
        for make in (lambda: FusedTransformerEncoderLayer(16, 2, 32,
                                                          device=device),
                     lambda: LayerNorm(16, device=device),
                     lambda: Linear(16, 8, device=device),
                     lambda: MoEForCausalLM(MoEConfig.tiny(), device=device),
                     lambda: MoELayer(16, 32, 4, device=device)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    moe = MoEForCausalLM(MoEConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        moe_train_step_factory(moe)
    assert moe_train_step_factory(moe, device="cpu")[1]["step"].device.type \
        == "cpu"
    assert MoELayer(16, 32, 4, device="cpu")(torch.randn(2, 4, 16)).shape \
        == (2, 4, 16)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_paged_decode_factory(model, page_size=4, n_pool_pages=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_train_step_factory(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg, 1, 8, 1)
    assert llama_paged_decode_factory(model, page_size=4, n_pool_pages=4,
                                      device="cpu")[2][0].device.type == "cpu"
    layer = FusedTransformerEncoderLayer(16, 2, 32, device="cpu")
    assert layer(torch.randn(2, 4, 16)).shape == (2, 4, 16)
    assert LayerNorm(16, device="cpu")(torch.randn(3, 16)).shape == (3, 16)
    assert Linear(16, 8, device="cpu")(torch.randn(3, 16)).shape == (3, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_serving_entry_points_refuse_a_missing_card():
    """The decode factories and the engine's model path: without CUDA a
    default or "cuda" device raises; "cpu" runs."""
    _needs_no_card()
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_decode_factory,
                                             llama_serving_decode_factory)
    from paddle_tpu_torch.serving import ServingEngine

    cfg = LlamaConfig.tiny(vocab=32, hidden=16, layers=1, heads=2,
                           kv_heads=1)
    model = LlamaForCausalLM(cfg, device="cpu")
    for device in (None, "cuda"):
        for make in (
                lambda: llama_decode_factory(model, device=device),
                lambda: llama_serving_decode_factory(
                    model, chunked_prefill=64, device=device),
                lambda: ServingEngine(model, device=device)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    eng = ServingEngine(model, slots=2, max_len=16, page_size=8,
                        clock="fixed", device="cpu")
    assert eng.device.type == "cpu"
    assert llama_decode_factory(model, max_len=16, device="cpu")(
        [[1, 2]], 2).device.type == "cpu"


def test_vision_entry_points_refuse_a_missing_card():
    """The vision slice's layers, models and train step: without CUDA a
    default or "cuda" device raises; "cpu" runs."""
    _needs_no_card()
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision.models import (LeNet, resnet18,
                                                resnet_train_step_factory)

    for device in (None, "cuda"):
        for make in (lambda: nn.Conv2D(1, 2, 3, device=device),
                     lambda: nn.BatchNorm2D(2, device=device),
                     lambda: LeNet(device=device),
                     lambda: resnet18(num_classes=4, device=device)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    model = LeNet(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet_train_step_factory(model)
    params, _, _, step = resnet_train_step_factory(model, device="cpu")
    out = step(params, {}, {"step": torch.zeros((), dtype=torch.int32),
                            "velocity": {k: torch.zeros_like(p)
                                         for k, p in params.items()},
                            "master": {}},
               torch.zeros(2, 1, 28, 28), [0, 1])
    assert out[3].device.type == "cpu"


def test_layer_slice_refuses_a_missing_card():
    """``nn.Layer().create_parameter``, the layers with parameters or
    buffers this slice added and the Llama / MoE layers run on the default
    device: without CUDA a default or "cuda" device raises; "cpu" runs."""
    _needs_no_card()
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.models.nlp import LlamaConfig
    from paddle_tpu_torch.models.nlp.llama import (LlamaAttention,
                                                   LlamaDecoderLayer,
                                                   LlamaMLP, LlamaModel)
    from paddle_tpu_torch.models.nlp.moe import MoEConfig, MoEForCausalLM

    assert place._default == torch.device("cuda")
    cfg = LlamaConfig.tiny(vocab=32, hidden=16, layers=1, heads=2,
                           kv_heads=1)
    for device in (None, "cuda"):
        kw = {} if device is None else {"device": device}
        for make in (lambda: nn.Layer().create_parameter([2, 3]),
                     lambda: nn.PReLU(3, **kw),
                     lambda: nn.Bilinear(2, 3, 4, **kw),
                     lambda: nn.GroupNorm(2, 4, **kw),
                     lambda: nn.InstanceNorm2D(3, **kw),
                     lambda: nn.SpectralNorm([3, 4], **kw),
                     lambda: nn.Linear(2, 3).to("gpu"),
                     lambda: LlamaAttention(cfg, **kw),
                     lambda: LlamaMLP(cfg, **kw),
                     lambda: LlamaDecoderLayer(cfg, **kw),
                     lambda: LlamaModel(cfg, **kw),
                     lambda: MoEForCausalLM(MoEConfig.tiny(), **kw)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    assert LlamaModel(cfg, device="cpu").norm.weight.device.type == "cpu"
    try:
        place.set_device("cpu")
        assert nn.Layer().create_parameter([2]).device.type == "cpu"
        assert nn.GroupNorm(2, 4).weight.device.type == "cpu"
    finally:
        place._default = torch.device("cuda")


def test_native_loader_build_failure_raises(monkeypatch, tmp_path):
    """A failed build of the native data path raises, at the ring, the
    batch assembler and the shared-memory DataLoader: nothing hands over
    to numpy or to threads."""
    import numpy as np
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.io import (DataLoader, Dataset, native_loader,
                                     shm_channel)
    from paddle_tpu_torch.utils import native

    class Rows(Dataset):
        def __getitem__(self, i):
            return np.float32(i)

        def __len__(self):
            return 8

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    prev = place._default
    try:
        place.set_device("cpu")
        for make in (lambda: native.get_lib(),
                     lambda: shm_channel.ShmRing("/ptt_x", create=True),
                     lambda: native_loader.NativeBatchAssembler(
                         np.zeros((4, 2), np.float32)),
                     lambda: iter(DataLoader(Rows(), batch_size=2,
                                             num_workers=2))):
            with pytest.raises(RuntimeError, match="native data-path "
                                                   "build failed"):
                make()
        # the synchronous and the thread path need no native library
        assert len(list(DataLoader(Rows(), batch_size=2))) == 4
        assert len(list(DataLoader(Rows(), batch_size=2, num_workers=2,
                                   use_shared_memory=False))) == 4
    finally:
        place._default = prev
    assert not (tmp_path / "build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_fit_slice_refuses_a_missing_card(tmp_path):
    """DataLoader, Model.fit / evaluate / predict / train_batch,
    paddle.load and the device statistics run on the default device:
    without CUDA they raise until the CPU is asked for (set_device, or
    the loader's places)."""
    _needs_no_card()
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place

    class Rows(paddle.io.Dataset):
        def __getitem__(self, i):
            return np.full(3, i, np.float32), np.int64(i % 2)

        def __len__(self):
            return 4

    assert place._default == torch.device("cuda")
    try:
        place.set_device("cpu")
        net = paddle.nn.Linear(3, 2)
        paddle.save(net.state_dict(), str(tmp_path / "w.pdparams"))
    finally:
        place._default = torch.device("cuda")
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.SGD(parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    for run in (lambda: list(paddle.io.DataLoader(Rows(), batch_size=2)),
                lambda: iter(paddle.io.DataLoader(Rows(), batch_size=2,
                                                  num_workers=2)),
                lambda: model.fit(Rows(), batch_size=2, verbose=0),
                lambda: model.evaluate(Rows(), batch_size=2, verbose=0),
                lambda: model.predict(Rows(), batch_size=2),
                lambda: model.train_batch([np.zeros((2, 3), np.float32)],
                                          [np.zeros(2, np.int64)]),
                lambda: paddle.load(str(tmp_path / "w.pdparams")),
                lambda: paddle.device.memory_allocated(),
                lambda: paddle.device.cuda.synchronize()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    batches = list(paddle.io.DataLoader(Rows(), batch_size=2,
                                        places=paddle.CPUPlace()))
    assert batches[0][0].device.type == "cpu"
    try:
        place.set_device("cpu")
        model.fit(Rows(), batch_size=2, verbose=0, shuffle=False)
        assert set(model.evaluate(Rows(), batch_size=2, verbose=0)) == {
            "loss", "acc"}
        assert paddle.load(str(tmp_path / "w.pdparams"))[
            "weight"].device.type == "cpu"
    finally:
        place._default = torch.device("cuda")


def test_op_namespace_refuses_a_missing_card():
    """to_tensor, the creation ops and the random ops run on the default
    device: without CUDA they raise until set_device("cpu") asks for the
    CPU (or to_tensor's place does)."""
    _needs_no_card()
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place

    assert place._default == torch.device("cuda")
    makes = (lambda: paddle.to_tensor([1.0, 2.0]),
             lambda: paddle.to_tensor(np.arange(3)),
             lambda: paddle.zeros([2]), lambda: paddle.ones([2]),
             lambda: paddle.full([2], 1.0), lambda: paddle.empty([2]),
             lambda: paddle.arange(4), lambda: paddle.linspace(0, 1, 3),
             lambda: paddle.logspace(0, 1, 3), lambda: paddle.eye(2),
             lambda: paddle.rand([2]), lambda: paddle.randn([2]),
             lambda: paddle.uniform([2]), lambda: paddle.normal(shape=[2]),
             lambda: paddle.randint(0, 5, [2]), lambda: paddle.randperm(4),
             lambda: paddle.standard_normal([2]),
             lambda: paddle.assign(np.ones(2)), lambda: paddle.Parameter(
                 [1.0]), lambda: paddle.create_parameter([2], "float32"),
             lambda: paddle.array_length([]))
    for make in makes:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    for name in ("gpu", "gpu:0", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.set_device(name)
    assert paddle.to_tensor([1.0], place="cpu").device.type == "cpu"
    try:
        paddle.set_device("cpu")
        assert all(make().device.type == "cpu" for make in makes
                   if make is not makes[-3] and make is not makes[-1])
    finally:
        place._default = torch.device("cuda")
    assert paddle.get_device() == "gpu:0"


def test_chip_smoke_refuses_without_a_card():
    _needs_no_card()
    proc = _run(["chip_smoke.py"], ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_chip_smoke_refuses_without_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
