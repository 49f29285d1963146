"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX
package, its entry points run on CUDA unless the caller asks for the CPU,
and ``chip_smoke.py`` refuses to run without a card or without the rest of
the repository."""
import os
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
             "paddle_tpu_torch.vision.models.resnet"):
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


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_entry_points_refuse_a_missing_card():
    """Without CUDA, a default or "cuda" device raises; "cpu" runs."""
    _needs_no_card()
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.examples.train_llama_compiled import train
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    from paddle_tpu_torch.nn import LayerNorm, Linear
    from paddle_tpu_torch.models.nlp import (LlamaConfig, LlamaForCausalLM,
                                             llama_paged_decode_factory,
                                             llama_train_step_factory)
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
                     lambda: Linear(16, 8, device=device)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
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
