"""Quantization toolkit (slim) of the PyTorch port.

Counterpart of ``paddle_tpu/quantization`` (~ python/paddle/fluid/contrib/
slim/quantization/: quantization_pass.py QAT fake-quant insertion,
imperative/qat.py ImperativeQuantAware, post_training_quantization.py).
Fake-quant is a straight-through-estimator op pair (quantization
simulated in the graph); PTQ calibrates activation scales with the
reference's numpy observers and freezes ``nn.Linear`` layers to
``Int8Linear`` (int8 weights per output channel, the int8 product of
``int8.py``), which ``jit.save`` exports like any layer. The decode path
also runs ``quantize_stacked`` / ``int8_matmul``.

Kept as the reference has them (ROADMAP Queue 3):
``ImperativeQuantAware`` matches class names exactly, so a subclass of
``Linear`` is not quantized.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..core.place import resolve_device
from ..ops.dispatch import apply_op
from .int8 import (QMAX, Int8Linear, convert_to_int8,  # noqa: F401
                   int8_matmul, quantize_stacked, quantize_weight_per_channel)
from .observers import (AbsMaxObserver, AvgObserver,  # noqa: F401
                        HistObserver, make_observer)


def _fake_qdq(v, s, bits):
    qmax = 2 ** (bits - 1) - 1
    s = torch.clamp_min(s, 1e-8)
    q = torch.clamp(torch.round(v / s * qmax), -qmax, qmax)
    deq = q * s / qmax
    # straight-through: gradient of round treated as identity
    return v + (deq - v).detach()


def fake_quantize_dequantize(x, scale, bits=8):
    """Symmetric per-tensor fake quant with straight-through gradient
    (~ fake_quantize_dequantize_moving_average_abs_max op)."""
    return apply_op("fake_quant_dequant", _fake_qdq, x, scale, bits=bits)


class FakeQuant(nn.Layer):
    """Moving-average abs-max observer + fake quant (~ imperative/qat.py)."""

    def __init__(self, bits=8, momentum=0.9):
        super().__init__()
        self.bits = bits
        self.momentum = momentum
        self.register_buffer("scale", torch.tensor(
            1.0, dtype=torch.float32, device=resolve_device()))
        self._observed = False

    def forward(self, x):
        if self.training:
            cur = float(x.detach().abs().max())
            with torch.no_grad():
                if not self._observed:
                    self.scale.fill_(cur)
                    self._observed = True
                else:
                    self.scale.copy_(self.momentum * self.scale
                                     + (1 - self.momentum) * cur)
        return fake_quantize_dequantize(x, self.scale, self.bits)


class QuantedLinear(nn.Layer):
    def __init__(self, linear, bits=8):
        super().__init__()
        self.inner = linear
        self.act_quant = FakeQuant(bits)
        self.w_quant = FakeQuant(bits)

    def forward(self, x):
        x = self.act_quant(x)
        w = self.w_quant(self.inner.weight)
        return nn.functional.linear(x, w, self.inner.bias)


class QuantedConv2D(nn.Layer):
    def __init__(self, conv, bits=8):
        super().__init__()
        self.inner = conv
        self.act_quant = FakeQuant(bits)
        self.w_quant = FakeQuant(bits)

    def forward(self, x):
        x = self.act_quant(x)
        w = self.w_quant(self.inner.weight)
        c = self.inner
        return nn.functional.conv2d(x, w, c.bias, c.stride, c.padding,
                                    c.dilation, c.groups, c.data_format)


class ImperativeQuantAware:
    """QAT transformer (~ slim/quantization/imperative/qat.py:104):
    swaps Linear/Conv2D sublayers for fake-quantized versions, by exact
    class name (the reference's)."""

    def __init__(self, bits=8, quantizable_layer_type=("Linear", "Conv2D")):
        self.bits = bits
        self.types = set(quantizable_layer_type)

    def quantize(self, model):
        for name, sub in list(model._modules.items()):
            if sub is None:
                continue
            cls = type(sub).__name__
            if cls == "Linear" and "Linear" in self.types:
                model._modules[name] = QuantedLinear(sub, self.bits)
            elif cls == "Conv2D" and "Conv2D" in self.types:
                model._modules[name] = QuantedConv2D(sub, self.bits)
            else:
                self.quantize(sub)
        return model

    def save_quantized_model(self, model, path, input_spec=None):
        from .. import jit
        jit.save(model, path, input_spec=input_spec)


def _host_array(x) -> np.ndarray:
    t = x.detach()
    if not t.is_floating_point() or t.dtype in (torch.bfloat16,
                                                torch.float16):
        t = t.to(torch.float32)
    return t.cpu().numpy()


class PostTrainingQuantization:
    """PTQ calibration (~ post_training_quantization.py:229).

    Runs calibration batches with forward pre-hooks observing every
    quantizable layer's input through the chosen algorithm (abs_max / avg
    / hist / KL, reference `algo` arg), then freezes the model to int8
    execution (per-channel int8 weights + static activation scales,
    ``int8.py``: the QuantizationFreezePass analog), in place. abs_max
    and avg observe the input's max |x| taken on the device (the same
    number the reference's observer takes of the whole array); hist and
    KL copy the input to the host."""

    def __init__(self, model, data_loader, bits=8, algo="abs_max",
                 quantizable_layer_type=("Linear",)):
        if bits != 8:
            raise ValueError("int8 is the quantized width (bits=8)")
        self.model = model
        self.loader = data_loader
        self.bits = bits
        self.algo = algo
        self.types = set(quantizable_layer_type)
        self.act_scales: dict[str, float] = {}

    def _observed_layers(self):
        for name, layer in self.model.named_sublayers():
            if type(layer).__name__ in self.types:
                yield name, layer

    def quantize(self):
        observers = {}
        hooks = []
        for name, layer in self._observed_layers():
            obs = make_observer(self.algo)
            observers[name] = obs

            def pre_hook(lyr, inputs, _obs=obs):
                x = inputs[0]
                if isinstance(_obs, (AbsMaxObserver, AvgObserver)):
                    # these read only max|x|: take it on the device and
                    # copy one number, not the activation
                    x = x.detach().abs().amax().reshape(1)
                _obs.update(_host_array(x))

            hooks.append(layer.register_forward_pre_hook(pre_hook))
        self.model.eval()
        try:
            with torch.no_grad():
                for batch in self.loader:
                    x = batch[0] if isinstance(batch, (list, tuple)) \
                        else batch
                    if not isinstance(x, torch.Tensor):
                        x = torch.as_tensor(np.asarray(x),
                                            device=resolve_device())
                    self.model(x)
        finally:
            for h in hooks:
                h.remove()
        self.act_scales = {name: obs.scale() / QMAX
                           for name, obs in observers.items()}
        return convert_to_int8(self.model, self.act_scales)

    def save_quantized_model(self, save_model_path, **kw):
        from ..framework.io import save
        state = {}
        for name, layer in self.model.named_sublayers():
            if isinstance(layer, Int8Linear):
                state[f"{name}.weight_int8"] = \
                    layer.weight_q.detach().cpu().numpy()
                state[f"{name}.weight_scale"] = \
                    layer.weight_scale.detach().cpu().numpy()
                if layer.act_scale is not None:
                    state[f"{name}.act_scale"] = float(layer.act_scale)
        save(state, save_model_path + ".pdquant")
        return state
