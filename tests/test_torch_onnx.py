"""``paddle.onnx`` of the PyTorch port against the JAX package's.

Mirrors ``tests/test_onnx_export.py`` and
``test_namespace_fillers.py::test_onnx_export_real_model``. An MLP, the
LeNet-like net of the reference's test and a conv-BN model are exported
by both packages from the same weights (the reference's ``paddle.save``,
the port's ``set_state_dict``) and decoded with the port's reader; they
must agree in the op types in order, each node's attributes, the wiring
(each value renamed by its order of first appearance), the initializers
bit for bit, and the graph inputs' and outputs' value infos. The
protobuf builders of ``proto`` give the reference's bytes for the same
messages. A model with an op that has no converter writes ``jit.save``'s
artifact set with a warning naming it, and loads.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as rp
import paddle_tpu_torch as tp
from paddle_tpu.onnx import proto as ref_proto
from paddle_tpu_torch.core import place
from paddle_tpu_torch.onnx import export, proto
from paddle_tpu_torch.onnx.exporter import UnsupportedOp


@pytest.fixture(autouse=True)
def on_cpu():
    prev = place._default
    tp.set_device("cpu")
    yield
    place._default = prev


def _decode_model(path):
    blob = open(path, "rb").read()
    model = proto.decode_message(blob)
    graph = proto.decode_message(model[7][0])
    nodes = [proto.decode_message(n) for n in graph.get(1, [])]
    inits = [proto.decode_message(t) for t in graph.get(5, [])]
    return model, graph, nodes, inits


def _op_types(nodes):
    return [n[4][0].decode() for n in nodes]


def _attrs(node):
    out = {}
    for a in node.get(5, []):
        d = proto.decode_message(a)
        out[d.pop(1)[0].decode()] = d
    return out


def _canonical(path):
    """The graph with every value renamed by its order of first
    appearance (inputs, then initializers, then node outputs)."""
    model, graph, nodes, inits = _decode_model(path)
    names = {}

    def name(n):
        return names.setdefault(n, f"v{len(names)}")

    ins = [proto.decode_message(v) for v in graph.get(11, [])]
    outs = [proto.decode_message(v) for v in graph.get(12, [])]
    for v in ins:
        name(v[1][0])
    init = sorted((name(t[8][0]), t.get(1, []), t[2], t[9][0])
                  for t in inits)
    wiring = [(n[4][0], [name(i) for i in n.get(1, [])],
               [name(o) for o in n.get(2, [])], _attrs(n)) for n in nodes]
    io = ([(name(v[1][0]), v[2]) for v in ins],
          [(name(v[1][0]), v[2]) for v in outs])
    return {"ir": model[1], "opset": model[8], "wiring": wiring,
            "init": init, "io": io}


def _export_both(make, spec, tmp_path, tag):
    """``make(pkg)`` in both packages on the reference's weights; each
    exported; their canonical graphs."""
    rp.seed(0)
    ref_net = make(rp)
    rp.save(ref_net.state_dict(), str(tmp_path / f"{tag}.pdparams"))
    port_net = make(tp)
    assert port_net.set_state_dict(
        tp.load(str(tmp_path / f"{tag}.pdparams"))) == ([], [])
    ref_net.eval()
    port_net.eval()
    want = rp.onnx.export(ref_net, str(tmp_path / f"{tag}_ref"),
                          input_spec=[rp.jit.InputSpec(spec)])
    got = export(port_net, str(tmp_path / f"{tag}_port"),
                 input_spec=[tp.jit.InputSpec(spec)])
    return _canonical(got), _canonical(want), got, port_net


class TestWire:
    def test_varint_roundtrip(self):
        msg = proto.emit_varint(3, 300) + proto.emit_string(2, "hi")
        d = proto.decode_message(msg)
        assert d[3] == [300] and d[2] == [b"hi"]
        assert msg == ref_proto.emit_varint(3, 300) + \
            ref_proto.emit_string(2, "hi")
        assert proto.emit_varint(1, -3) == ref_proto.emit_varint(1, -3)

    def test_tensor_proto_raw_data(self):
        arr = np.arange(6, dtype=np.float32).reshape(2, 3)
        t = proto.decode_message(proto.tensor_proto("w", arr))
        assert t[1] == [2, 3]                      # dims
        assert t[2] == [proto.DataType.FLOAT]      # data_type
        assert t[8] == [b"w"]                      # name
        back = np.frombuffer(t[9][0], np.float32).reshape(2, 3)
        np.testing.assert_array_equal(back, arr)

    def test_builders_write_the_reference_bytes(self):
        arr = np.arange(6, dtype=np.int64).reshape(3, 2)
        assert proto.tensor_proto("t", arr) == \
            ref_proto.tensor_proto("t", arr)
        attrs = {"perm": [1, 0], "alpha": 0.5, "mode": "x", "k": 3,
                 "flag": True, "scales": [0.5, 2.0], "t": arr}
        node = proto.node_proto("Foo", ["a", "b"], ["c"], "n", attrs)
        assert node == ref_proto.node_proto("Foo", ["a", "b"], ["c"], "n",
                                            attrs)
        vi = proto.value_info_proto("x", [-1, 3], np.float32)
        assert vi == ref_proto.value_info_proto("x", [-1, 3], np.float32)
        graph = proto.graph_proto("g", [node], [vi], [vi], [])
        assert graph == ref_proto.graph_proto("g", [node], [vi], [vi], [])
        assert proto.model_proto(graph, 13) == \
            ref_proto.model_proto(graph, 13)
        assert proto.onnx_dtype("bfloat16") == proto.DataType.BFLOAT16


class TestExportMLP:
    def test_mlp_structure_against_the_reference(self, tmp_path):
        def make(pkg):
            nn = pkg.nn
            return nn.Sequential(nn.Linear(4, 8), nn.ReLU(),
                                 nn.Linear(8, 3))

        got, want, path, _ = _export_both(make, [2, 4], tmp_path, "mlp")
        assert path.endswith(".onnx")
        assert got == want
        _, graph, nodes, inits = _decode_model(path)
        assert _op_types(nodes) == ["MatMul", "Add", "Relu", "MatMul",
                                    "Add"]
        assert sorted(tuple(t.get(1, [])) for t in inits) == [
            (3,), (4, 8), (8,), (8, 3)]
        assert proto.decode_message(graph[11][0])[1] == [b"x0"]

    def test_initializer_values_match(self, tmp_path):
        m = tp.nn.Linear(3, 2)
        m.eval()
        path = export(m, str(tmp_path / "lin"),
                      input_spec=[tp.jit.InputSpec([1, 3])])
        _, _, _, inits = _decode_model(path)
        found = [np.frombuffer(t[9][0], np.float32).reshape(3, 2)
                 for t in inits if t[1] == [3, 2]]
        assert len(found) == 1
        np.testing.assert_array_equal(found[0], m.weight.detach().numpy())

    def test_bfloat16_initializers_are_their_bits(self, tmp_path):
        m = tp.nn.Linear(3, 2)
        m.to(torch.bfloat16)
        m.eval()
        path = export(m, str(tmp_path / "bf"), input_spec=[
            tp.jit.InputSpec([1, 3], "bfloat16")])
        _, _, _, inits = _decode_model(path)
        w = [t for t in inits if t[1] == [3, 2]][0]
        assert w[2] == [proto.DataType.BFLOAT16]
        np.testing.assert_array_equal(
            np.frombuffer(w[9][0], np.uint16),
            m.weight.detach().view(torch.int16).numpy().view(
                np.uint16).ravel())

    def test_edge_wiring(self, tmp_path):
        m = tp.nn.Sequential(tp.nn.Linear(4, 4), tp.nn.Sigmoid())
        m.eval()
        path = export(m, str(tmp_path / "s"),
                      input_spec=[tp.jit.InputSpec([1, 4])])
        _, graph, nodes, _ = _decode_model(path)
        produced = {proto.decode_message(v)[1][0] for v in graph.get(11, [])}
        produced |= {proto.decode_message(t)[8][0]
                     for t in graph.get(5, [])}
        for n in nodes:
            for i in n.get(1, []):
                assert i in produced, f"dangling edge {i}"
            produced |= set(n.get(2, []))
        gout = {proto.decode_message(v)[1][0] for v in graph.get(12, [])}
        assert gout <= produced


def _lenet_like(pkg):
    nn = pkg.nn
    F = pkg.nn.functional

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(1, 4, 3, stride=1, padding=1)
            self.bn = nn.BatchNorm2D(4)
            self.fc = nn.Linear(4 * 4 * 4, 10)

        def forward(self, x):
            h = F.relu(self.bn(self.conv(x)))
            h = F.max_pool2d(h, 2)
            h = pkg.flatten(h, start_axis=1)
            return F.softmax(self.fc(h), axis=-1)

    return Net()


def _conv_bn(pkg):
    nn = pkg.nn

    class ConvBN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.c1 = nn.Conv2D(3, 8, 3, stride=2, padding=1, bias_attr=False)
            self.bn = nn.BatchNorm2D(8, epsilon=1e-3)
            self.c2 = nn.Conv2D(8, 4, 1, groups=4)
            self.ln = nn.LayerNorm(8)

        def forward(self, x):
            h = nn.functional.avg_pool2d(
                nn.functional.gelu(self.bn(self.c1(x))), 2, stride=1)
            h = pkg.transpose(self.c2(h), [0, 2, 3, 1])
            h = pkg.concat([h, pkg.tanh(h)], axis=-1)
            return pkg.sum(self.ln(h), axis=[1, 2])

    return ConvBN()


class TestExportConvNet:
    def test_lenet_like_against_the_reference(self, tmp_path):
        got, want, path, _ = _export_both(_lenet_like, [1, 1, 8, 8],
                                          tmp_path, "lenet")
        assert got == want
        _, _, nodes, _ = _decode_model(path)
        ops = _op_types(nodes)
        assert ops[0] == "Conv"
        assert {"BatchNormalization", "MaxPool", "Reshape",
                "Softmax"} <= set(ops)
        attrs = _attrs(nodes[0])
        assert attrs["strides"][8] == [1, 1]
        assert attrs["pads"][8] == [1, 1, 1, 1]
        assert attrs["group"][3] == [1]

    def test_conv_bn_against_the_reference(self, tmp_path):
        got, want, _, _ = _export_both(_conv_bn, [2, 3, 8, 8], tmp_path,
                                       "convbn")
        assert got == want
        assert [w[0] for w in got["wiring"]] == [
            b"Conv", b"BatchNormalization", b"Gelu", b"AveragePool",
            b"Conv", b"Transpose", b"Tanh", b"Concat", b"LayerNormalization",
            b"ReduceSum"]

    def test_vision_lenet_exports(self, tmp_path):
        net = tp.vision.models.LeNet()
        net.eval()
        path = export(net, str(tmp_path / "lenet"),
                      input_spec=[tp.jit.InputSpec([1, 1, 28, 28])])
        _, _, nodes, inits = _decode_model(path)
        assert _op_types(nodes)[0] == "Conv"
        n_params = sum(1 for _ in net.parameters())
        assert len(inits) >= n_params

    def test_unsupported_op_raises(self, tmp_path):
        class Odd(tp.nn.Layer):
            def forward(self, x):
                return tp.cumsum(x, axis=0)

        with pytest.raises(UnsupportedOp, match="cumsum"):
            export(Odd(), str(tmp_path / "odd"),
                   input_spec=[tp.jit.InputSpec([2, 2])],
                   fallback_stablehlo=False)
        assert tp.in_dynamic_mode()

    def test_fallback_writes_the_export_artifacts(self, tmp_path):
        class Odd(tp.nn.Layer):
            def forward(self, x):
                return tp.cumsum(x, axis=0)

        with pytest.warns(UserWarning, match="torch.export artifact set"):
            out = export(Odd(), str(tmp_path / "odd2"),
                         input_spec=[tp.jit.InputSpec([2, 2])])
        assert sorted(os.listdir(tmp_path)) == [
            "odd2.pdexport", "odd2.pdiparams", "odd2.pdmeta", "odd2.pdmodel"]
        layer = tp.jit.load(out)
        x = torch.arange(4.0).reshape(2, 2)
        np.testing.assert_array_equal(layer(x).numpy(),
                                      torch.cumsum(x, 0).numpy())
        assert tp.in_dynamic_mode()


def test_onnx_export_real_model(tmp_path):
    net = tp.nn.Linear(4, 2)
    out = tp.onnx.export(net, str(tmp_path / "m"),
                         input_spec=[tp.jit.InputSpec([1, 4])])
    assert out.endswith(".onnx") and (tmp_path / "m.onnx").exists()
