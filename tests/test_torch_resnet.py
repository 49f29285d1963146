"""The port's vision training path against the JAX package's, on the same
weights (the reference's ``state_dict()`` through
``nn.load_numpy_state_dict``) and the same seeded numpy inputs, float32 on
both sides:

* ``resnet18(num_classes=10)`` at 32 x 32, B = 8, as
  ``tests/test_resnet_train.py`` builds it: train-mode logits, loss and
  the batch norms' running statistics after the forward, then eval-mode
  logits; and 3 steps of ``resnet_train_step_factory`` against the
  reference's on a one-device mesh (losses, every parameter, velocity and
  buffer) at 64 x 64, B = 8;
* ``resnet50(num_classes=10)`` (``BottleneckBlock``s, full width) at 32 x
  32, B = 8: logits, loss, running statistics and one factory step;
* the bfloat16 factory: parameters bf16, buffers and masters f32, a
  finite loss, masters that move;
* LeNet: logits and 3 factory steps against the reference's factory, and
  LeNet on synthetic MNIST to the bar of ``tests/test_e2e_lenet.py``;
* MNIST's synthetic digits and IDX reading against the reference's;
* the refusals (``pretrained``, ``mesh``) and the default device.

Tolerance: f32 on both sides, apart by the order of sums in the
convolutions and the batch statistics. Single layers agree to 2e-5
(``tests/test_torch_vision_nn.py``). Through ResNet-18 the train-mode
logits agree to 1e-4 absolute (``LOGITS_TOL``, as the Llama and BERT
logits of the port's other tests), the loss to 1e-5 and the running
statistics to 2e-5.

The gradient of a small-input ResNet is not a smooth function of its
input: where a ReLU's input lies within f32 noise of 0, the two packages'
orders of sums can send it to either side, and a batch norm over a few
positions (1 x 1 x 8 in ResNet-18's last stage at 32 x 32) spreads that
one flip over its channel. Against the port's own float64 run at 32 x 32,
B = 8, the reference's f32 ResNet-18 gradient lies 0.57 % away (median
over parameters) and the port's 9e-6; at 64 x 64 (2 x 2 x 8 positions)
both lie within 4e-6. So the 3 ResNet-18 steps run at 64 x 64, held to
1e-4 absolute and relative (``STEP_TOL``: parameters and buffers) and
velocities to 2e-4 (``VELOCITY_TOL``: a velocity sums three noisy
gradients). ResNet-50 stays noisy at every input this file can afford
(the port's own f32 gradient lies 1.0 % from float64 at 32 x 32, B = 8):
its test holds each package's f32 numbers against the port's float64
run on the same weights and batch, and the reference may lie at most
``F64_RATIO`` = 3 times as far from it as the port's f32 run, with
parameters after the step apart by lr times their velocities' gap and
buffers by 1e-4 relative. ``-s`` prints each test's readings (err /
limit, or the ratios): ResNet-18 logits 0.33, statistics 0.034, steps
0.093 (parameters), 0.48 (velocities), 0.096 (buffers); ResNet-50 ratios
1.07 (logits), 1.69 (velocities, median over parameters) and 0.89
(worst); LeNet at most 0.008.
"""
import gzip
import struct
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.vision import datasets as ref_datasets
from paddle_tpu.vision import models as ref_models
from paddle_tpu.vision.models.resnet import (
    resnet_train_step_factory as ref_factory)
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import Generator
from paddle_tpu_torch.vision import datasets as port_datasets
from paddle_tpu_torch.vision import models as port_models
from paddle_tpu_torch.vision.models import resnet_train_step_factory

LOGITS_TOL = dict(atol=1e-4, rtol=0)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
STATS_TOL = dict(atol=2e-5, rtol=2e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
VELOCITY_TOL = dict(atol=2e-4, rtol=2e-4)
F64_RATIO = 3.0


def _data(B=8, hw=32, classes=10, seed=0, channels=3):
    """Class-template images plus noise (``tests/test_resnet_train.py``'s
    ``_data``), int labels."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(0, 1, (classes, channels, hw, hw)).astype(
        np.float32)
    y = rng.integers(0, classes, B)
    x = (templates[y] + 0.3 * rng.normal(0, 1, (B, channels, hw, hw))
         ).astype(np.float32)
    return x, y.astype(np.int32)


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _close(readings, key, got, want, atol, rtol, err_msg=""):
    """``assert_allclose``, recording the largest err / limit under
    ``key`` (``-s`` prints each test's readings)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                               err_msg=err_msg)
    over = float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))
    readings[key] = max(readings.get(key, 0.0), over)


def _pair(make_ref, make_port, seed=0):
    paddle.seed(seed)
    ref = make_ref()
    port = make_port()
    state = _state(ref)
    assert sorted(port.state_dict()) == sorted(state)
    return ref, tnn.load_numpy_state_dict(port, state)


def _mesh():
    return Mesh(np.asarray(jax.devices("cpu")[:1]), ("data",))


def _loss(logits, y):
    logp = torch.log_softmax(logits.float(), -1)
    return float(-logp[torch.arange(len(y)), torch.from_numpy(y).long()]
                 .mean())


def _ref_loss(logits, y):
    logp = jax.nn.log_softmax(np.asarray(logits, np.float32), -1)
    return float(-np.mean(np.asarray(logp)[np.arange(len(y)), y]))


def _forward_matches(ref, port, x, y, readings):
    """Train-mode logits, loss and running statistics, then eval-mode
    logits."""
    ref.train()
    port.train()
    ref_logits = ref(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        port_logits = port(torch.from_numpy(x))
    _close(readings, "logits", port_logits.numpy(), ref_logits,
           **LOGITS_TOL)
    _close(readings, "loss", _loss(port_logits, y), _ref_loss(ref_logits, y),
           **LOSS_TOL)
    ref_state, n_stats = _state(ref), 0
    for k, v in port.state_dict().items():
        if k.endswith(("_mean", "_variance")):
            _close(readings, "stats", v.numpy(), ref_state[k], **STATS_TOL,
                   err_msg=k)
            n_stats += 1
    ref.eval()
    port.eval()
    with torch.no_grad():
        _close(readings, "eval_logits", port(torch.from_numpy(x)).numpy(),
               ref(paddle.to_tensor(x)).numpy(), **LOGITS_TOL)
    return n_stats


def _steps_match(ref, port, x, y, n_steps, readings, lr=0.1):
    """``n_steps`` of both factories from the same weights: losses, then
    every parameter, velocity and buffer."""
    r_params, r_bufs, r_opt, r_step = ref_factory(ref, _mesh(),
                                                  learning_rate=lr)
    params, bufs, opt, step = resnet_train_step_factory(
        port, learning_rate=lr, device="cpu")
    assert sorted(params) == sorted(r_params)
    assert sorted(bufs) == sorted(r_bufs)
    r_losses, losses = [], []
    for _ in range(n_steps):
        r_params, r_bufs, r_opt, r_loss = r_step(r_params, r_bufs, r_opt,
                                                 x, y)
        params, bufs, opt, loss = step(params, bufs, opt, x, y)
        r_losses.append(float(r_loss))
        losses.append(float(loss))
    _close(readings, "step_losses", losses, r_losses, **LOSS_TOL)
    assert int(opt["step"]) == int(r_opt["step"]) == n_steps
    for name, mine, theirs, tol in (
            ("params", params, r_params, STEP_TOL),
            ("velocities", opt["velocity"], r_opt["velocity"], VELOCITY_TOL),
            ("buffers", bufs, r_bufs, STEP_TOL)):
        for k, v in mine.items():
            _close(readings, name, v.detach().numpy(), np.asarray(theirs[k]),
                   **tol, err_msg=f"{name} {k}")
    return losses


def _grad_distance_to_f64(ref, state, make, x, y):
    """Median over parameters of the relative distance of the reference's
    f32 gradient (its tape) and of the port's f32 gradient to the port's
    float64 gradient of the same loss, weights and batch."""
    ref.train()
    paddle.nn.functional.cross_entropy(
        ref(paddle.to_tensor(x)),
        paddle.to_tensor(y.astype(np.int64))).backward()
    grads = {"reference": {k: p.grad.numpy()
                           for k, p in ref.named_parameters()}}
    for dtype in (torch.float32, torch.float64):
        port = tnn.load_numpy_state_dict(make(), state).to(dtype).train()
        torch.nn.functional.cross_entropy(
            port(torch.from_numpy(x).to(dtype)),
            torch.from_numpy(y).long()).backward()
        grads[str(dtype)] = {k: p.grad.double().numpy()
                             for k, p in port.named_parameters()}
    truth = grads.pop("torch.float64")
    return {name: float(np.median([_rel(g[k], t) for k, t in truth.items()]))
            for name, g in grads.items()}


def test_resnet18_logits_loss_stats_and_three_steps_match_jax():
    x, y = _data()
    readings = {}
    ref, port = _pair(lambda: ref_models.resnet18(num_classes=10),
                      lambda: port_models.resnet18(num_classes=10,
                                                   device="cpu"))
    assert _forward_matches(ref, port, x, y, readings) == 2 * 20
    # why the steps run at 64 x 64 (see the module's docstring): each
    # package's f32 gradient against the port's float64 one, at 32 x 32
    # and at 64 x 64 (printed, not held)
    for hw in (32, 64):
        xs, ys = _data(hw=hw)
        ref, port = _pair(lambda: ref_models.resnet18(num_classes=10),
                          lambda: port_models.resnet18(num_classes=10,
                                                       device="cpu"), seed=1)
        readings[f"grad_to_f64_at_{hw}"] = _grad_distance_to_f64(
            ref, _state(ref), lambda: port_models.resnet18(
                num_classes=10, device="cpu"), xs, ys)
    x, y = _data(hw=64)
    ref, port = _pair(lambda: ref_models.resnet18(num_classes=10),
                      lambda: port_models.resnet18(num_classes=10,
                                                   device="cpu"), seed=1)
    port.eval()          # the step trains in training mode all the same
    losses = _steps_match(ref, port, x, y, 3, readings)
    print("resnet18 readings (err / limit):", readings)
    assert not port.training
    assert losses[-1] < losses[0]


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / np.linalg.norm(b))


def test_bottleneck_resnet50_logits_and_one_step_match_jax():
    """``resnet50(num_classes=10)`` at 32 x 32, B = 8: train-mode logits,
    loss and running statistics, and the velocity and parameters after one
    factory step, each package's f32 numbers held against the port's
    float64 run on the same weights and batch (the truth here: see the
    module's docstring). The reference must lie no further from it than
    ``F64_RATIO`` times the port's own f32 run (readings in the module's
    docstring)."""
    x, y = _data()
    paddle.seed(1)
    ref = ref_models.resnet50(num_classes=10)
    state = _state(ref)
    r_params, r_bufs, r_opt, r_step = ref_factory(ref, _mesh())
    ref.train()
    ref_logits = ref(paddle.to_tensor(x)).numpy()
    ref_stats = _state(ref)

    def port_run(dtype):
        port = port_models.resnet50(num_classes=10, device="cpu")
        tnn.load_numpy_state_dict(port, state)
        port = port.to(dtype).train()
        logits = port(torch.from_numpy(x).to(dtype))
        loss = torch.nn.functional.cross_entropy(
            logits.double(), torch.from_numpy(y).long())
        grads = torch.autograd.grad(loss, list(port.parameters()))
        stats = {k: v.double().numpy() for k, v in port.state_dict().items()
                 if k.endswith(("_mean", "_variance"))}
        return (logits.detach().double().numpy(), float(loss), stats,
                {k: g.double().numpy() + 1e-4 * p.detach().double().numpy()
                 for (k, p), g in zip(port.named_parameters(), grads)})

    p32, p64 = port_run(torch.float32), port_run(torch.float64)
    assert "layer1.0.conv3.weight" in p64[3] and len(p64[2]) == 2 * 53
    err = lambda a: float(np.abs(a - p64[0]).max())      # noqa: E731
    readings = {"logits": err(ref_logits) / err(p32[0])}
    assert err(ref_logits) <= F64_RATIO * err(p32[0]) + 1e-6
    assert abs(_ref_loss(ref_logits, y) - p64[1]) <= \
        F64_RATIO * abs(p32[1] - p64[1]) + 1e-6
    for k, truth in p64[2].items():
        assert _rel(ref_stats[k], truth) <= \
            F64_RATIO * _rel(p32[2][k], truth) + 1e-6, k

    # one step of each factory from the same weights
    port = port_models.resnet50(num_classes=10, device="cpu")
    tnn.load_numpy_state_dict(port, state)
    params, bufs, opt, step = resnet_train_step_factory(port, device="cpu")
    params, bufs, opt, loss = step(params, bufs, opt, x, y)
    r_params, r_bufs, r_opt, r_loss = r_step(r_params, r_bufs, r_opt, x, y)
    np.testing.assert_allclose(float(loss), p32[1], rtol=1e-6)
    e_ref = {k: _rel(r_opt["velocity"][k], v) for k, v in p64[3].items()}
    e_port = {k: _rel(opt["velocity"][k].numpy(), v)
              for k, v in p64[3].items()}
    readings.update(
        velocity_median=(np.median(list(e_ref.values()))
                         / np.median(list(e_port.values()))),
        velocity_worst=max(e_ref.values()) / max(e_port.values()),
        velocity_median_port_to_f64=np.median(list(e_port.values())))
    print("resnet50 readings (reference / port distance to float64):",
          readings)
    assert np.median(list(e_ref.values())) <= \
        F64_RATIO * np.median(list(e_port.values())) + 1e-6
    assert max(e_ref.values()) <= F64_RATIO * max(e_port.values()) + 1e-6
    for k, p in params.items():     # p1 = p0 - lr * v1 on both sides
        d_v = np.abs(opt["velocity"][k].numpy()
                     - np.asarray(r_opt["velocity"][k]))
        np.testing.assert_array_less(
            np.abs(p.detach().numpy() - np.asarray(r_params[k])),
            0.1 * d_v + 1e-6, err_msg=k)
    for k, b in bufs.items():
        assert _rel(np.asarray(r_bufs[k]), b.double().numpy()) <= 1e-4, k


def test_bf16_factory_keeps_buffers_and_masters_f32():
    model = port_models.resnet18(num_classes=10, device="cpu").to(
        torch.bfloat16)
    assert all(b.dtype == torch.bfloat16 for b in model.buffers())
    params, bufs, opt, step = resnet_train_step_factory(model, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in params.values())
    assert bufs and all(b.dtype == torch.float32 for b in bufs.values())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert sorted(opt["master"]) == sorted(params)
    assert all(m.dtype == torch.float32 for m in opt["master"].values())
    assert all(v.dtype == torch.float32 for v in opt["velocity"].values())
    m0 = {k: m.clone() for k, m in opt["master"].items()}
    mean0 = bufs["bn1._mean"].clone()
    x, y = _data()
    params, bufs, opt, loss = step(params, bufs, opt,
                                   torch.from_numpy(x).bfloat16(), y)
    assert np.isfinite(float(loss))
    assert all(b.dtype == torch.float32 for b in bufs.values())
    assert not torch.equal(bufs["bn1._mean"], mean0)
    moved = sum(not torch.equal(m, m0[k]) for k, m in opt["master"].items())
    assert moved == len(m0)
    k = "fc.weight"
    assert torch.equal(params[k], opt["master"][k].to(torch.bfloat16))


def test_lenet_logits_and_three_steps_match_jax():
    digits = port_datasets.MNIST(mode="test")
    x = np.stack([digits[i][0] for i in range(16)])
    y = digits.labels[:16].astype(np.int32)
    ref, port = _pair(lambda: ref_models.LeNet(),
                      lambda: port_models.LeNet(device="cpu"))
    assert sorted(port.state_dict()) == [
        "fc.0.bias", "fc.0.weight", "fc.1.bias", "fc.1.weight",
        "fc.2.bias", "fc.2.weight", "features.0.bias", "features.0.weight",
        "features.3.bias", "features.3.weight"]
    readings = {}
    assert _forward_matches(ref, port, x, y, readings) == 0
    losses = _steps_match(ref, port, x, y, 3, readings, lr=0.05)
    print("lenet readings (err / limit):", readings)
    assert losses[-1] < losses[0]


def test_lenet_trains_on_synthetic_mnist():
    """The bar of ``tests/test_e2e_lenet.py``'s eager test (last loss <
    0.7 x the first, training accuracy > 0.5) on the same 512 images,
    batches of 64, 3 shuffled epochs, with the port's
    ``resnet_train_step_factory`` (momentum SGD, lr 0.05), which suits any
    model; ``test_lenet_trains_eagerly_with_adam`` trains with Adam, as
    the reference test does."""
    train = port_datasets.MNIST(mode="train")
    xs = np.stack([train[i][0] for i in range(512)])
    ys = train.labels[:512]
    model = port_models.LeNet(device="cpu", generator=Generator(0))
    params, bufs, opt, step = resnet_train_step_factory(
        model, learning_rate=0.05, device="cpu")
    assert bufs == {}
    order = np.random.default_rng(0)
    first = last = None
    for _ in range(3):
        perm = order.permutation(512)
        for i in range(0, 512, 64):
            idx = perm[i:i + 64]
            params, bufs, opt, loss = step(params, bufs, opt, xs[idx],
                                           ys[idx])
            first = float(loss) if first is None else first
            last = float(loss)
    assert last < 0.7 * first, (first, last)
    model.eval()
    with torch.no_grad():
        pred = model(torch.from_numpy(xs)).argmax(-1).numpy()
    assert (pred == ys).mean() > 0.5


def test_lenet_trains_eagerly_with_adam():
    """The reference's ``test_lenet_trains_eager`` on the port: Adam (lr
    1e-3), ``F.cross_entropy``, ``loss.backward(); opt.step();
    opt.clear_grad()`` over the same 512 images, batches of 64, 3
    shuffled epochs; the same bar (last loss < 0.7 x the first, training
    accuracy > 0.5)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import functional as F

    train = port_datasets.MNIST(mode="train")
    xs = torch.from_numpy(np.stack([train[i][0] for i in range(512)]))
    ys = torch.from_numpy(train.labels[:512].astype(np.int64))
    model = port_models.LeNet(device="cpu", generator=Generator(0))
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    order = np.random.default_rng(0)
    first = last = None
    for _ in range(3):
        perm = torch.from_numpy(order.permutation(512))
        for i in range(0, 512, 64):
            idx = perm[i:i + 64]
            loss = F.cross_entropy(model(xs[idx]), ys[idx])
            loss.backward()
            opt.step()
            opt.clear_grad()
            first = float(loss.detach()) if first is None else first
            last = float(loss.detach())
    assert last < 0.7 * first, (first, last)
    model.eval()
    with torch.no_grad():
        pred = model(xs).argmax(-1)
    assert (pred == ys).float().mean() > 0.5


def _write_idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + b"".join(
        struct.pack(">I", n) for n in arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_matches_the_reference(tmp_path, gz):
    imgs, labels = port_datasets._synthetic_digits(64, seed=5)
    ref_imgs, ref_labels = ref_datasets._synthetic_digits(64, seed=5)
    np.testing.assert_array_equal(imgs, ref_imgs)
    np.testing.assert_array_equal(labels, ref_labels)
    suffix = ".gz" if gz else ""
    ip, lp = tmp_path / f"i{suffix}", tmp_path / f"l{suffix}"
    _write_idx(str(ip), imgs, gz)
    _write_idx(str(lp), labels, gz)
    port = port_datasets.MNIST(str(ip), str(lp))
    ref = ref_datasets.MNIST(str(ip), str(lp))
    assert len(port) == len(ref) == 64
    for i in (0, 17, 63):
        for a, b in zip(port[i], ref[i]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    test = port_datasets.MNIST(mode="test", image_path=None, label_path=None)
    assert len(test) == 10000 and test[0][0].shape == (1, 28, 28)


# meshes the factories refuse before reading anything else of them
_PIPE_MESH = types.SimpleNamespace(shape={"data": 1, "pipe": 2},
                                   axis_names=("data", "pipe"))
_EXPERT_MESH = types.SimpleNamespace(shape={"expert": 2},
                                     axis_names=("expert",))


def test_refusals_and_the_default_device():
    with pytest.raises(NotImplementedError, match="item 6"):
        port_models.resnet50(pretrained=True, device="cpu")
    model = port_models.LeNet(device="cpu")
    # a mesh trains (test_torch_models_mesh.py); "pipe" above 1 and axes
    # the factory does not know are refused
    with pytest.raises(NotImplementedError, match="item 15"):
        resnet_train_step_factory(model, _PIPE_MESH, device="cpu")
    with pytest.raises(ValueError, match="expert"):
        resnet_train_step_factory(model, _EXPERT_MESH, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_models.resnet18()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resnet_train_step_factory(model)
    else:
        with pytest.raises(ValueError, match="build it with"):
            resnet_train_step_factory(model)
