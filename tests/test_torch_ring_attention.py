"""Ring, window-ring and Ulysses attention on a "sep" axis: the port against
the JAX package.

The port's functions take each rank's chunk of the sequence; they run in
one world of 4 gloo ranks on the CPU (``torch_dist_ranks``, started once
for the module), on {sep 4} and on {data 2, sep 2} (two rings of 2). The
reference's take the global arrays and run on 2 or 4 of the 8 host
devices, their Pallas kernels in interpret mode. On the same numpy-seeded
f32 inputs, each rank's output chunk and its q / k / v gradients of
sum(out * do) (``jax.vjp`` on the reference's side) agree within 1e-5
relative + 1e-5 absolute:

* ``ring_attention``, causal and not, at sep 2 and 4, on the flash engine
  (S/n = 256, head_dim 64: the flash kernels' plain versions) and the
  dense one (S/n = 32, head_dim 16), with kv groups G = 1 and 2;
* ``ring_window_attention`` at several (sep, S, window), on the splash
  engine (S/n = 256) and the dense one, including windows whose ring
  skips steps and the degenerate window of 1; ``ring_window_active_steps``
  equals the reference's over a grid;
* ``ulysses_attention``, causal and not, on the flash kernels (S = 512)
  and the dense softmax, and its ValueError for heads that do not divide
  the axis, in the reference's words. The flag's routing in the Llama
  attention is held in ``test_torch_llama_sep.py``.
"""
import numpy as np
import pytest

import torch_dist_ranks as R

TOL = dict(rtol=1e-5, atol=1e-5)
SEP2 = {"data": 2, "sep": 2}
SEP4 = {"sep": 4}


def _case(kind, dims, S, Hq, Hkv, D, causal=True, window=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((1, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((1, Hkv, S, D)).astype(np.float32)
    do = rng.standard_normal((1, Hq, S, D)).astype(np.float32)
    return dict(kind=kind, dims=dims, q=q, k=k, v=v, do=do, causal=causal,
                window=window)


CASES = {}
for _n, _dims in ((2, SEP2), (4, SEP4)):
    for _G in (1, 2):
        for _causal in (True, False):
            _tag = f"n{_n}_g{_G}_{'causal' if _causal else 'full'}"
            CASES[f"ring_flash_{_tag}"] = _case(
                "ring", _dims, 256 * _n, 2, 2 // _G, 64, _causal)
            CASES[f"ring_dense_{_tag}"] = _case(
                "ring", _dims, 32 * _n, 4, 4 // _G, 16, _causal, seed=1)
# (dims, S, window, Hq, Hkv): active steps of n in the comment
WINDOWS = {
    "splash_n4_w300": (SEP4, 1024, 300, 2, 1),    # 3 of 4
    "splash_n4_w600": (SEP4, 1024, 600, 2, 2),    # 4 of 4
    "splash_n2_w100": (SEP2, 512, 100, 2, 1),     # 1 of 2
    "splash_n4_w1": (SEP4, 1024, 1, 2, 1),        # degenerate: 1 of 4
    "dense_n4_w24": (SEP4, 64, 24, 4, 2),         # 3 of 4
    "dense_n2_w24": (SEP2, 64, 24, 2, 2),         # 2 of 2
    "dense_n4_w1": (SEP4, 64, 1, 2, 1),           # degenerate: 1 of 4
}
for _name, (_dims, _S, _w, _hq, _hkv) in WINDOWS.items():
    CASES[f"window_{_name}"] = _case("window", _dims, _S, _hq, _hkv,
                                     64 if _name.startswith("splash") else 16,
                                     window=_w, seed=2)
for _causal in (True, False):
    _tag = "causal" if _causal else "full"
    CASES[f"ulysses_flash_{_tag}"] = _case("ulysses", SEP2, 512, 4, 4, 64,
                                           _causal, seed=3)
    CASES[f"ulysses_dense_{_tag}"] = _case("ulysses", SEP4, 64, 4, 4, 16,
                                           _causal, seed=3)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    scenarios = [("cases", "sep_attention", dict(cases=CASES))]
    return R.run_world(tmp_path_factory.mktemp("ring_attention"), 4,
                       scenarios)


def _readings(world, name):
    out = [r[name] for r in world]
    for r, o in enumerate(out):
        assert "error" not in o, f"rank {r}: {o.get('error')}"
    return out


def _ref(c):
    """The reference's output and q / k / v gradients on the global
    arrays, on a mesh of sep devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from paddle_tpu.parallel.ring_attention import (ring_attention,
                                                    ring_window_attention)
    from paddle_tpu.parallel.ulysses import ulysses_attention
    n = c["dims"]["sep"]
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sep",))

    def fn(q, k, v):
        if c["kind"] == "ring":
            return ring_attention(q, k, v, mesh, causal=c["causal"])
        if c["kind"] == "window":
            return ring_window_attention(q, k, v, mesh, c["window"])
        return ulysses_attention(q, k, v, mesh, causal=c["causal"])

    @jax.jit
    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)

    out, grads = fwd_bwd(*(jnp.asarray(c[x]) for x in ("q", "k", "v",
                                                         "do")))
    return {"out": np.asarray(out),
            **{f"d{x}": np.asarray(g) for x, g in zip("qkv", grads)}}


def test_ranks_import_neither_jax_nor_the_jax_package(world):
    assert all(r["_loaded"] == [] for r in world)


@pytest.mark.parametrize("name", list(CASES))
def test_chunks_match_the_reference(world, name):
    c = CASES[name]
    want = _ref(c)
    n = c["dims"]["sep"]
    s = c["q"].shape[2] // n
    for r, o in enumerate(_readings(world, "cases")):
        got = o[name]
        mine = slice(got["sep"] * s, (got["sep"] + 1) * s)
        for key in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(got[key], want[key][:, :, mine],
                                       **TOL, err_msg=f"rank {r} {key}")


def test_window_active_steps_match_the_reference():
    from paddle_tpu.parallel.ring_attention import \
        ring_window_active_steps as ref
    from paddle_tpu_torch.parallel import ring_window_active_steps
    for n in (1, 2, 3, 4, 8):
        for Sloc in (16, 128, 256, 2048):
            for window in (1, 2, 3, 17, 128, 129, 300, 2048, 4096, 4097,
                           10 ** 6):
                assert ring_window_active_steps(n, window, Sloc) == \
                    ref(n, window, Sloc), (n, window, Sloc)
    assert ring_window_active_steps(4, 4096, 2048) == 3


def test_ulysses_refuses_indivisible_heads():
    """6 heads over sep = 4: the reference's ValueError, word for word
    (raised before any exchange, so a one-process mesh of 4 ranks
    shows it)."""
    import types

    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import Mesh
    from paddle_tpu.parallel.ulysses import ulysses_attention as ref
    from paddle_tpu_torch.distributed.topology import ParallelGroup
    from paddle_tpu_torch.parallel import ulysses_attention
    with pytest.raises(ValueError) as want:
        x = jnp.zeros((1, 6, 32, 16))
        ref(x, x, x, Mesh(np.asarray(jax.devices()[:4]), ("sep",)))
    mesh = types.SimpleNamespace(
        group=lambda axis: ParallelGroup([0, 1, 2, 3], 0, axis))
    x = torch.zeros(1, 6, 8, 16)
    with pytest.raises(ValueError) as got:
        ulysses_attention(x, x, x, mesh)
    assert str(got.value) == str(want.value)
