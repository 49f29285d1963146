"""``nn.Layer`` and its containers in the PyTorch port against the JAX
package's, and the API's small leftovers:

* a ``Layer`` subclass script as a Paddle user writes it (``create_parameter``,
  ``add_parameter``, ``add_sublayer``, ``register_buffer`` with
  ``persistable``): the same ``state_dict()`` keys in the same order
  (every parameter before every persistable buffer), the same values on
  the same weights, ``named_sublayers`` / ``sublayers(include_self=)``,
  ``apply``, ``full_name``;
* the forward hooks: pre-hooks in registration order, each may replace
  the inputs (a tuple or one value); post-hooks after ``forward``, each
  may replace the output; ``HookRemoveHelper.remove``; the same call
  logs and outputs as the reference;
* ``set_state_dict`` / ``load_dict`` returning ``(missing,
  unexpected)``, and its ValueError on a shape mismatch;
  ``tree_flatten_params`` / ``load_tree``;
* ``to`` / ``astype`` / ``bfloat16`` / ``float``: the parameters' and
  floating buffers' dtypes as the reference's, integer buffers kept;
  torch's forms (``to(tensor)``, ``to(dtype)``) and torch's machinery
  (``copy.deepcopy``, a plain ``torch.nn.Module`` parent's
  ``state_dict`` / ``load_state_dict``);
* ``LayerList``, ``Sequential``, ``ParameterList`` and ``LayerDict``:
  indexing, slices, insertion and iteration as the reference's, its
  traps included (``LayerList[-1] = layer`` adds a sublayer named "-1";
  ``ParameterList[-1]`` raises KeyError; a ``Sequential`` slice is a
  list);
* ``get_rng_state`` / ``set_rng_state``, ``is_grad_enabled``,
  ``in_dynamic_mode``, ``set_printoptions``, ``paddle.batch`` and the
  dtype predicates against the reference.

Tolerance: 1e-5 absolute and relative (float32 on both sides).
"""
import collections
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu.core import dtype as ref_dtype
import paddle_tpu_torch as tp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import dtype as port_dtype
from paddle_tpu_torch.core import place

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def on_cpu():
    """The port's default device set to the CPU for the test, as a script
    would with ``paddle.set_device``, then put back."""
    prev = place._default
    tp.set_device("cpu")
    yield
    place._default = prev


def _net(nn):
    """The same user script against either package."""

    class Block(nn.Layer):
        def __init__(self, n_in):
            super().__init__()
            self.fc = nn.Linear(n_in, 3)
            self.bn = nn.BatchNorm1D(3)
            self.scale = self.create_parameter([3], is_bias=True)

        def forward(self, x):
            return self.bn(self.fc(x)) * self.scale

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.blocks = nn.LayerList([Block(4), Block(3)])
            self.add_sublayer("head", nn.Linear(3, 2))
            self.add_parameter("bias", self.create_parameter(
                [2], default_initializer=nn.initializer.Constant(0.5)))
            self.register_buffer("steps", paddle_zeros(nn), persistable=True)
            self.register_buffer("cache", paddle_zeros(nn),
                                 persistable=False)

        def forward(self, x):
            for b in self.blocks:
                x = b(x)
            return self.head(x) + self.bias

    return Net()


def paddle_zeros(nn):
    return (paddle.zeros([2]) if nn is ref_nn
            else torch.zeros(2, device=place._default))


def _pair(seed=0):
    paddle.seed(seed)
    ref = _net(ref_nn)
    port = _net(tnn)
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    tnn.load_numpy_state_dict(port, state)
    return ref, port, state


def _x(shape=(5, 4), seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_state_dict_keys_order_and_forward_match_the_reference(on_cpu):
    ref, port, state = _pair()
    assert list(port.state_dict()) == list(state)
    # every parameter, then every persistable buffer, each in pre-order
    assert list(state)[-5:] == ["steps", "blocks.0.bn._mean",
                                "blocks.0.bn._variance", "blocks.1.bn._mean",
                                "blocks.1.bn._variance"]
    assert "cache" not in port.state_dict()
    x = _x()
    want = ref(paddle.to_tensor(x)).numpy()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert isinstance(port.parameters(), list)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    assert [n for n, _ in port.named_buffers()] == \
        [n for n, _ in ref.named_buffers()]
    assert all(p.requires_grad and p.device.type == "cpu"
               for p in port.parameters())
    assert len(port.parameters(include_sublayers=False)) == 1


def test_sublayers_apply_and_names_match_the_reference(on_cpu):
    ref, port, _ = _pair()
    for include_self in (False, True):
        want = [(n, type(l).__name__) for n, l in
                ref.named_sublayers(include_self=include_self)]
        got = [(n, type(l).__name__) for n, l in
               port.named_sublayers(include_self=include_self)]
        assert got == want
        assert len(port.sublayers(include_self)) == len(
            ref.sublayers(include_self))
    seen_r, seen_p = [], []
    ref.apply(lambda l: seen_r.append(type(l).__name__))
    port.apply(lambda l: seen_p.append(type(l).__name__))
    assert seen_p == seen_r
    names = {l.full_name() for l in port.sublayers(include_self=True)}
    assert len(names) == len(port.sublayers(include_self=True))
    assert port.blocks.full_name().startswith("layerlist_")


def _hooked(layer, log, pkg):
    def pre1(l, inputs):
        log.append("pre1")
        return inputs[0] * 2.0          # one value: wrapped in a tuple

    def pre2(l, inputs):
        log.append(("pre2", len(inputs)))

    def post1(l, inputs, out):
        log.append("post1")
        return out + 1.0

    def post2(l, inputs, out):
        log.append("post2")
        return None

    return [layer.register_forward_pre_hook(pre1),
            layer.register_forward_pre_hook(pre2),
            layer.register_forward_post_hook(post1),
            layer.register_forward_post_hook(post2)]


def test_hooks_run_in_the_reference_order_and_replace_values(on_cpu):
    ref, port, _ = _pair()
    x = _x()
    logs = {}
    outs = {}
    for name, layer, arg in (("ref", ref.head, paddle.to_tensor(x[:, :3])),
                             ("port", port.head,
                              torch.from_numpy(x[:, :3]))):
        logs[name] = []
        handles = _hooked(layer, logs[name], name)
        outs[name] = np.asarray(layer(arg).detach().numpy()
                                if name == "port" else layer(arg).numpy())
        handles[0].remove()
        handles[2].remove()
        outs[name + "_removed"] = np.asarray(
            layer(arg).detach().numpy() if name == "port"
            else layer(arg).numpy())
    assert logs["port"] == logs["ref"] == [
        "pre1", ("pre2", 1), "post1", "post2", ("pre2", 1), "post2"]
    np.testing.assert_allclose(outs["port"], outs["ref"], **TOL)
    np.testing.assert_allclose(outs["port_removed"], outs["ref_removed"],
                               **TOL)
    assert isinstance(handles[0], tnn.HookRemoveHelper)


def test_hooks_reach_the_llama_layers(on_cpu):
    from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(layers=1), device="cpu")
    calls = []
    h = model.model.layers[0].self_attn.register_forward_pre_hook(
        lambda l, i: calls.append("attn"))
    model.model.register_forward_post_hook(
        lambda l, i, o: calls.append("model"))
    model(torch.zeros(1, 4, dtype=torch.long))
    h.remove()
    model(torch.zeros(1, 4, dtype=torch.long))
    assert calls == ["attn", "model", "model"]


def test_set_state_dict_returns_missing_and_unexpected(on_cpu):
    ref, port, state = _pair()
    paddle.seed(5)
    other = {k: v + 1.0 for k, v in state.items() if "blocks.0" not in k}
    other["extra.weight"] = np.ones(3, np.float32)
    want = ref.set_state_dict({k: paddle.to_tensor(v)
                               for k, v in other.items()})
    got = port.set_state_dict(other)
    assert got == (list(want[0]), list(want[1]))
    assert got[1] == ["extra.weight"] and all("blocks.0" in k
                                              for k in got[0])
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), other.get(k, state[k]), **TOL)
    assert port.load_dict({"head.bias": torch.zeros(2)})[1] == []
    with pytest.raises(ValueError, match="shape mismatch"):
        port.set_state_dict({"head.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ref.set_state_dict({"head.bias": paddle.zeros([3])})


def test_tree_flatten_params_and_load_tree(on_cpu):
    _, port, state = _pair()
    tree = port.tree_flatten_params()
    assert list(tree) == list(state)
    port.load_tree({k: v * 0 + 2.0 for k, v in tree.items()
                    if k.startswith("head.")})
    assert bool((port.head.weight == 2.0).all())


def test_to_astype_and_dtype_match_the_reference(on_cpu):
    ref, port, _ = _pair()
    port.register_buffer("count", torch.zeros(2, dtype=torch.int32))
    ref.to(dtype="bfloat16")
    port.to(dtype="bfloat16")
    want = {k: str(v.dtype) for k, v in ref.state_dict().items()}
    got = {k: str(v.dtype).removeprefix("torch.")
           for k, v in port.state_dict().items() if k != "count"}
    assert got == want and set(got.values()) == {"bfloat16"}
    assert port.count.dtype == torch.int32
    assert port.blocks[0].fc._dtype == torch.bfloat16
    port.float()
    assert port.head.weight.dtype == torch.float32
    port.astype("float16")
    assert port.head.weight.dtype == torch.float16
    port.bfloat16()
    assert port.head.weight.dtype == torch.bfloat16
    port.to(torch.zeros(1, dtype=torch.float32))      # torch's form
    assert port.head.weight.dtype == torch.float32
    port.to("cpu", "float64", True)                    # Paddle's positions
    assert port.head.weight.dtype == torch.float64
    port.to(tp.CPUPlace())
    assert port.head.weight.device.type == "cpu"


def test_torch_machinery_still_works_on_layers(on_cpu):
    _, port, state = _pair()
    twin = copy.deepcopy(port)
    assert twin.head.weight is not port.head.weight
    torch.testing.assert_close(twin.head.weight, port.head.weight)
    parent = torch.nn.Module()
    parent.net = port
    sd = parent.state_dict()
    assert set(sd) == {"net." + k for k in state}
    missing, unexpected = parent.load_state_dict(sd)
    assert not missing and not unexpected
    assert port.state_dict(structured_name_prefix="top.").keys() == {
        "top." + k for k in state}
    assert list(port.state_dict(include_sublayers=False)) == ["bias",
                                                              "steps"]
    port.zero_grad()
    port.train()
    assert port.training and port.blocks[0].bn.training
    port.eval()
    assert not port.blocks[1].bn.training


def test_layer_list_matches_the_reference(on_cpu):
    def lists(nn):
        paddle.seed(3)
        return nn.LayerList([nn.Linear(2, 2) for _ in range(3)])

    ref, port = lists(ref_nn), lists(tnn)
    for nn, ll in ((ref_nn, ref), (tnn, port)):
        ll.append(nn.ReLU())
        ll.insert(1, nn.Tanh())
        ll.extend([nn.Sigmoid()])
        ll[0] = nn.Identity() if nn is tnn else ref_nn.Identity()
    names = [(n, type(l).__name__) for n, l in port.named_children()]
    assert [n for n, _ in names] == [n for n, _ in ref.named_children()]
    assert len(port) == len(ref) == 6
    assert type(port[-1]).__name__ == "Sigmoid"
    assert isinstance(port[1:3], tnn.LayerList) and len(port[1:3]) == 2
    assert [type(l).__name__ for l in port] == [type(l).__name__.replace(
        "Relu", "ReLU") for l in ref]
    # the reference's trap: a negative index adds a sublayer named "-1"
    ref[-1] = ref_nn.ReLU()
    port[-1] = tnn.ReLU()
    assert "-1" in dict(port.named_children()) and len(port) == len(ref)


def test_sequential_parameter_list_and_layer_dict_match_the_reference(on_cpu):
    paddle.seed(4)
    ref = ref_nn.Sequential(("a", ref_nn.Linear(3, 4)), ("act", ref_nn.ReLU()),
                            ("b", ref_nn.Linear(4, 2)))
    port = tnn.Sequential(("a", tnn.Linear(3, 4)), ("act", tnn.ReLU()),
                          ("b", tnn.Linear(4, 2)))
    tnn.load_numpy_state_dict(port, {k: v.numpy() for k, v in
                                     ref.state_dict().items()})
    x = _x((2, 3))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               ref(paddle.to_tensor(x)).numpy(), **TOL)
    assert list(port.state_dict()) == list(ref.state_dict())
    assert isinstance(port[0:2], list) and isinstance(ref[0:2], list)
    assert type(port[-1]) is tnn.Linear and len(port) == 3
    od = tnn.Sequential(collections.OrderedDict([("x", tnn.Tanh()),
                                                 ("y", tnn.ReLU())]))
    assert [n for n, _ in od.named_children()] == ["x", "y"]

    params = [torch.nn.Parameter(torch.ones(2)) for _ in range(2)]
    pl = tnn.ParameterList(params)
    pl.append(torch.nn.Parameter(torch.zeros(3)))
    rl = ref_nn.ParameterList([paddle.create_parameter([2], "float32")
                               for _ in range(2)])
    rl.append(paddle.create_parameter([3], "float32"))
    assert list(pl.state_dict()) == list(rl.state_dict()) == ["0", "1", "2"]
    assert len(pl) == 3 and pl[2].shape == (3,) and len(list(pl)) == 3
    with pytest.raises(KeyError):          # the reference's: names only
        pl[-1]
    with pytest.raises(KeyError):
        rl[-1]

    ld, rd = tnn.LayerDict({"a": tnn.ReLU()}), ref_nn.LayerDict(
        {"a": ref_nn.ReLU()})
    for d, nn in ((ld, tnn), (rd, ref_nn)):
        d["b"] = nn.Tanh()
        d.update([("c", nn.Sigmoid())])
        d.pop("a")
    assert list(ld.keys()) == list(rd.keys()) == ["b", "c"]
    assert "b" in ld and len(ld) == 2 and list(ld) == ["b", "c"]
    del ld["b"]
    ld.clear()
    assert len(ld) == 0


def test_create_parameter_uses_attr_dtype_and_default_device(on_cpu):
    layer = tnn.Layer(dtype="float64")
    p = layer.create_parameter([2, 3])
    assert p.dtype == torch.float64 and p.device.type == "cpu"
    assert p.requires_grad
    frozen = layer.create_parameter(
        [2], "float32", attr=tnn.ParamAttr(trainable=False),
        is_bias=True)
    assert not frozen.requires_grad and bool((frozen == 0).all())


def test_rng_state_round_trip_matches_the_reference_contract(on_cpu):
    tp.seed(7)
    tp.rand([3])
    state = tp.get_rng_state()
    a = tp.rand([3])
    tp.rand([3])
    tp.set_rng_state(state)
    torch.testing.assert_close(tp.rand([3]), a)
    paddle.seed(7)
    rs = paddle.get_rng_state()
    ra = paddle.rand([3]).numpy()
    paddle.set_rng_state(rs)
    np.testing.assert_array_equal(paddle.rand([3]).numpy(), ra)


def test_small_api_leftovers_match_the_reference():
    assert tp.is_grad_enabled() is paddle.is_grad_enabled() is True
    with tp.no_grad():
        assert not tp.is_grad_enabled()
    assert tp.in_dynamic_mode() is paddle.in_dynamic_mode() is True

    def reader():
        yield from range(7)

    for drop in (False, True):
        assert list(tp.batch(reader, 3, drop)()) == list(
            paddle.batch(reader, 3, drop)())
    saved = torch._tensor_str.PRINT_OPTS.precision
    try:
        tp.set_printoptions(precision=2)
        assert "1.23" in repr(torch.tensor([1.23456]))
    finally:
        torch.set_printoptions(precision=saved)
    for name in ("float32", "bfloat16", "float16", "int32", "int64", "uint8",
                 "bool", "complex64"):
        for pred in ("is_floating_point", "is_integer", "is_bool",
                     "is_complex"):
            assert getattr(port_dtype, pred)(name) == getattr(
                ref_dtype, pred)(name), (name, pred)
