"""The port's fused transformer layers (``incubate.nn``) against the JAX
package's, on the same weights (the reference layer's ``state_dict()``
through ``nn.load_numpy_state_dict``) and the same numpy inputs, at
dropout 0 in training mode: output and the gradient of every parameter
of ``(out ** 2).mean()``. Post-LN layers run the dropout-add-LayerNorm
epilogue on both sides (the Pallas kernel in interpret mode, the port's
plain versions); S = 8 takes the plain attention on both sides, S = 256
with head_dim 64 the flash path (the JAX Pallas kernel in interpret mode
against the port's plain flash through its autograd Function).

Tolerance: float32 on both sides, apart by the order of sums in the
matrix products, the row statistics and the softmax: 2e-5 absolute and
relative for outputs and gradients (largest reading: 0.037 of the limit,
the S = 256 encoder layer).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import nn as ref_inc
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.incubate import nn as port_inc
from paddle_tpu_torch.ops import fused_dropout_add_layer_norm

TOL = (2e-5, 2e-5)


def _make(kind, E, heads, F, normalize_before, activation="gelu"):
    """(reference layer, port layer with the reference's weights)."""
    paddle.seed(0)
    if kind == "ffn":
        args = (E, F)
        kw = dict(dropout_rate=0.0, activation=activation,
                  normalize_before=normalize_before)
    elif kind == "attn":
        args = (E, heads)
        kw = dict(dropout_rate=0.0, attn_dropout_rate=0.0,
                  normalize_before=normalize_before)
    else:
        args = (E, heads, F)
        kw = dict(dropout_rate=0.0, activation=activation,
                  normalize_before=normalize_before)
    cls = {"ffn": "FusedFeedForward", "attn": "FusedMultiHeadAttention",
           "layer": "FusedTransformerEncoderLayer"}[kind]
    ref = getattr(ref_inc, cls)(*args, **kw)
    port = getattr(port_inc, cls)(*args, **kw, device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    tnn.load_numpy_state_dict(port, state)
    return ref, port


CASES = [  # (kind, E, heads, F, S, normalize_before)
    ("ffn", 32, None, 64, 8, False),
    ("ffn", 32, None, 64, 8, True),
    ("attn", 32, 4, None, 8, False),
    ("attn", 32, 4, None, 8, True),
    ("attn", 128, 2, None, 256, False),
    ("layer", 32, 4, 64, 8, False),
    ("layer", 32, 4, 64, 8, True),
    ("layer", 128, 2, 256, 256, False),
]


@pytest.mark.parametrize("kind,E,heads,F,S,normalize_before", CASES,
                         ids=[f"{c[0]}-E{c[1]}-S{c[4]}-"
                              f"{'pre' if c[5] else 'post'}" for c in CASES])
def test_fused_layer_matches_jax(kind, E, heads, F, S, normalize_before):
    ref, port = _make(kind, E, heads, F, normalize_before)
    x = np.random.default_rng(S + E).standard_normal((2, S, E)) \
        .astype(np.float32)

    rx = paddle.to_tensor(x)
    r_out = ref(rx)
    (r_out ** 2).mean().backward()
    t_out = port(torch.from_numpy(x))
    (t_out ** 2).mean().backward()

    np.testing.assert_allclose(t_out.detach().numpy(), r_out.numpy(),
                               atol=TOL[0], rtol=TOL[1])
    ref_params = dict(ref.named_parameters())
    port_params = dict(port.named_parameters())
    assert sorted(ref_params) == sorted(port_params)
    for name, p in port_params.items():
        r_grad = ref_params[name].grad
        if r_grad is None:          # ln_pre of a post-LN layer is unused
            assert p.grad is None, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), r_grad.numpy(),
                                   atol=TOL[0], rtol=TOL[1], err_msg=name)


def test_dropout_keeps_half_at_p_half():
    """p = 0.5, as the reference's ``test_dropout_active_in_train``: a
    training layer is stochastic and an eval one is not; and both of the
    port's dropouts keep about half of the elements (16384 of them: the
    fraction's spread is 0.004), scaling the kept ones by 2."""
    ffn = port_inc.FusedFeedForward(16, 32, dropout_rate=0.5, device="cpu")
    x = torch.randn(2, 4, 16)
    assert not torch.equal(ffn(x), ffn(x))
    ffn.eval()
    assert torch.equal(ffn(x), ffn(x))

    gen = torch.Generator().manual_seed(0)
    kept = tnn.functional.dropout(torch.ones(64, 256), 0.5, generator=gen)
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    assert abs(float((kept > 0).float().mean()) - 0.5) < 0.02
    # the epilogue: x = 100 and |residual| < 1 normalise above 0 exactly
    # where x was kept
    out = fused_dropout_add_layer_norm(
        torch.full((64, 256), 100.0), torch.rand(64, 256) - 0.5,
        torch.ones(256), torch.zeros(256), p=0.5, generator=gen)
    assert abs(float((out > 0).float().mean()) - 0.5) < 0.02


def test_incubate_subpackages_resolve_after_the_package_import():
    """In a fresh process, ``import paddle_tpu_torch as paddle`` makes
    ``paddle.incubate.nn`` and ``paddle.incubate.distributed`` attributes,
    as the reference's ``incubate/__init__`` does; a name not ported yet
    is refused by name."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import paddle_tpu_torch as paddle\n"
            "print(paddle.incubate.nn.FusedMultiTransformer.__name__)\n"
            "print(paddle.incubate.distributed.models.moe.__name__)\n"
            "try:\n    paddle.incubate.LookAhead\n"
            "except NotImplementedError as e:\n    print(e)\n")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "FusedMultiTransformer"
    assert lines[1].endswith("incubate.distributed.models.moe")
    assert "item 16" in lines[2]
