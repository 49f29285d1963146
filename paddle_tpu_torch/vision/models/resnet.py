"""The ResNet family of the PyTorch port, and its train step.

Counterpart of ``paddle_tpu/vision/models/resnet.py`` (``BasicBlock`` :7,
``BottleneckBlock`` :31, ``ResNet`` :62, ``resnet_train_step_factory``
:124, the constructors :228-285). Built from the port's ``nn`` layers with
the reference's attribute names, so ``state_dict()`` keys equal the
reference's (``conv1.weight``, ``bn1._mean``, ``layer1.0.downsample.1.
_variance``, ``fc.weight``, ...) and a reference state dict loads with
``nn.load_numpy_state_dict``. Every module is made in f32 on ``device``
(``cuda`` unless ``"cpu"`` is asked for) from ``generator`` (the default
generator when None); cast a model with ``.to(dtype)``. No TPU kernel lies
on this path: the convolutions are cuDNN's, the batch norms and pools
the reference's formulas in PyTorch.

``pretrained=True`` is refused: its weights would need a download.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ...core.place import resolve_device
from ...ops.manipulation import flatten


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 generator=None):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        kw = dict(device=device, generator=generator)
        self.conv1 = pnn.Conv2D(inplanes, planes, 3, stride=stride,
                                padding=1, bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, device=device)
        self.relu = pnn.ReLU()
        self.conv2 = pnn.Conv2D(planes, planes, 3, padding=1,
                                bias_attr=False, **kw)
        self.bn2 = norm_layer(planes, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 generator=None):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        kw = dict(device=device, generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = pnn.Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, device=device)
        self.conv2 = pnn.Conv2D(width, width, 3, padding=dilation,
                                stride=stride, groups=groups,
                                dilation=dilation, bias_attr=False, **kw)
        self.bn2 = norm_layer(width, device=device)
        self.conv3 = pnn.Conv2D(width, planes * self.expansion, 1,
                                bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, device=device)
        self.relu = pnn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device=None, generator=None):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        kw = dict(device=device, generator=generator)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = pnn.BatchNorm2D
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = pnn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                                bias_attr=False, **kw)
        self.bn1 = self._norm_layer(self.inplanes, device=device)
        self.relu = pnn.ReLU()
        self.maxpool = pnn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], **kw)
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2, **kw)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2, **kw)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2, **kw)
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = pnn.Linear(512 * block.expansion, num_classes, **kw)

    def _make_layer(self, block, planes, blocks, stride=1, **kw):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = pnn.Sequential(
                pnn.Conv2D(self.inplanes, planes * block.expansion, 1,
                           stride=stride, bias_attr=False, **kw),
                norm_layer(planes * block.expansion, device=kw["device"]))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, norm_layer=norm_layer,
                        **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, **kw))
        return pnn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def resnet_train_step_factory(model, mesh=None, learning_rate=0.1,
                              momentum=0.9, weight_decay=1e-4, *,
                              device=None):
    """Momentum SGD with L2 decay coupled into the gradient, for any model
    whose forward maps images to logits (the ResNet family, LeNet): the
    recipe of BASELINE.md's config 2, on one device.

    Returns ``(params, buffers, opt_state, step)``: ``params`` are the
    model's own parameters ({state-dict key: tensor}, made trainable; no
    copy is held), ``buffers`` its own buffers (the batch norms' running
    statistics), each floating one re-cast to f32 on the model if
    ``.to()`` cast it (the blends keep their buffer's dtype), and
    ``opt_state`` ``{"step", "velocity": f32 zeros for every parameter,
    "master": an f32 copy of every parameter that is not f32}``.
    ``step(params, buffers, opt_state, images, labels) -> (params,
    buffers, opt_state, loss)`` runs the forward in training
    mode (the model's mode is restored after; its batch norms blend their
    running statistics in place), the loss as the reference's step
    computes it (``log_softmax`` of the logits in f32, the mean NLL of the
    int labels), the backward, and per parameter, in f32: g + weight_decay
    · p (every parameter, the norms' and the biases' too), v = momentum ·
    v + that, p -= learning_rate · v, written back (to the master, and to
    the parameter in its dtype). IN PLACE: the arguments are the dicts the
    factory returned (the counterpart of the reference's
    ``donate_argnums``).

    Not ported yet, and refused: ``mesh`` (data parallel: ROADMAP Queue 1
    item 15)."""
    dev = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError(
            "mesh axes (data parallel) are not ported yet: ROADMAP Queue 1 "
            "item 15, distributed / parallel")
    params = dict(model.named_parameters())
    on = {p.device.type for p in params.values()}
    if on != {dev.type}:
        raise ValueError(f"the model lives on {sorted(on)}; build it with "
                         f"device={dev}")
    for p in params.values():
        p.requires_grad_(True)
    saved = model.state_dict(keep_vars=True)
    buffers = {}
    for name, buf in model.named_buffers():
        if name not in saved:
            continue
        if buf.is_floating_point() and buf.dtype != torch.float32:
            owner, _, leaf = name.rpartition(".")
            model.get_submodule(owner).register_buffer(
                leaf, buf.to(torch.float32))
        buffers[name] = model.get_buffer(name)
    opt_state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "velocity": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for k, p in params.items()},
        "master": {k: p.detach().to(torch.float32).clone()
                   for k, p in sorted(params.items())
                   if p.dtype != torch.float32}}

    def train_step(params, buffers, opt_state, images, labels):
        images = torch.as_tensor(images, device=dev)
        labels = torch.as_tensor(labels, device=dev).long()
        was_training = model.training
        model.train()
        try:
            logits = model(images)
        finally:
            model.train(was_training)
        logp = torch.log_softmax(logits.to(torch.float32), -1)
        loss = -torch.mean(torch.gather(logp, -1, labels[:, None])[:, 0])
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                master = opt_state["master"].get(k)
                p32 = master if master is not None else p.to(torch.float32)
                g = g.to(torch.float32) + weight_decay * p32
                v = opt_state["velocity"][k]
                v.mul_(momentum).add_(g)
                p32 = p32 - learning_rate * v
                if master is not None:
                    master.copy_(p32)
                p.copy_(p32)
            opt_state["step"] += 1
        return params, buffers, opt_state, loss.detach()

    return params, buffers, opt_state, train_step


def _resnet(block, depth, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained=True: the weights would need a download, which the "
            "port never makes (ROADMAP Queue 1 item 6); load a state dict "
            "with nn.load_numpy_state_dict instead")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=32, width=4,
                   **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=64, width=4,
                   **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=32, width=4,
                   **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=64, width=4,
                   **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, groups=32, width=4,
                   **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, groups=64, width=4,
                   **kwargs)
