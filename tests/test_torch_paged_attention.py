"""The port's paged attention (paddle_tpu_torch/ops/paged_attention.py)
against the JAX package's: the Pallas kernel run in interpret mode on the
CPU, and its dense oracle. The same numpy inputs go to both.

Tolerance: f32 inputs, atol 1e-5 / rtol 1e-5 — both sides accumulate in
f32 but in a different order (online softmax over pages vs one exact
softmax), so agreement is to a few f32 ulps of values of order 1.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.nlp.llama_decode import _q8 as jax_q8
from paddle_tpu_torch.models.nlp.llama_decode import _q8 as torch_q8

# the packages re-export the function under the module's name, so take
# the modules from the import system
jpa = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")
tpa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")

ATOL = RTOL = 1e-5


def _inputs(seed, B, Hkv, G, D=16, P=12, ps=8, W=4, quant=False, C=None):
    rng = np.random.default_rng(seed)
    qshape = (B, Hkv * G, D) if C is None else (B, Hkv * G, C, D)
    q = rng.normal(0, 1, qshape).astype(np.float32)
    if quant:
        kp = rng.integers(-127, 128, (Hkv, P, ps, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (Hkv, P, ps, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (Hkv, P, ps)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (Hkv, P, ps)).astype(np.float32)
    else:
        kp = rng.normal(0, 1, (Hkv, P, ps, D)).astype(np.float32)
        vp = rng.normal(0, 1, (Hkv, P, ps, D)).astype(np.float32)
        ks = vs = None
    pt = np.stack([rng.choice(np.arange(1, P), W, replace=False)
                   for _ in range(B)]).astype(np.int32)
    return q, kp, vp, ks, vs, pt


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_matches_pallas_kernel(G, quant):
    """Ragged lengths (mid-page, page edge, one token) and a pad row of
    length 0, which must come out exactly 0."""
    q, kp, vp, ks, vs, pt = _inputs(G + 10 * quant, B=5, Hkv=2, G=G,
                                    quant=quant)
    sl = np.asarray([13, 16, 1, 0, 32], np.int32)
    want = np.asarray(jpa.paged_attention(
        _j(q), _j(kp), _j(vp), _j(pt), _j(sl), k_scales=_j(ks),
        v_scales=_j(vs)))
    got = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(pt), _t(sl),
                              k_scales=_t(ks), v_scales=_t(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert not np.any(got[3]), "a length-0 pad row must be exactly 0"
    assert not np.any(want[3])


@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_matches_jax_oracle(G):
    q, kp, vp, _, _, pt = _inputs(20 + G, B=3, Hkv=2, G=G)
    sl = np.asarray([7, 25, 32], np.int32)
    want = np.asarray(jpa.paged_attention_reference(
        _j(q), _j(kp), _j(vp), _j(pt), _j(sl)))
    got = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(pt),
                              _t(sl)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    ref = tpa.paged_attention_reference(_t(q), _t(kp), _t(vp), _t(pt),
                                        _t(sl)).numpy()
    np.testing.assert_allclose(ref, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("start", [0, 8, 16])
@pytest.mark.parametrize("G,quant", [(1, False), (2, False), (4, False),
                                     (2, True)])
def test_prefill_chunk_matches_pallas_kernel(start, G, quant):
    """A C-token chunk at absolute start 0 or >0, causal over absolute
    positions and bounded by each sequence's real length."""
    C = 8
    q, kp, vp, ks, vs, pt = _inputs(30 + start + G, B=2, Hkv=2, G=G, C=C,
                                    quant=quant)
    sl = np.asarray([start + C, start + C - 3], np.int32)
    want = np.asarray(jpa.paged_prefill_attention(
        _j(q), _j(kp), _j(vp), _j(pt), _j(sl), start, k_scales=_j(ks),
        v_scales=_j(vs)))
    got = tpa.paged_prefill_attention(
        _t(q), _t(kp), _t(vp), _t(pt), _t(sl), start, k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    ref = tpa.paged_attention_reference(
        _t(q), _t(kp), _t(vp), _t(pt), _t(sl), k_scales=_t(ks),
        v_scales=_t(vs), q_start=start).numpy()
    np.testing.assert_allclose(ref, want, atol=ATOL, rtol=RTOL)


def test_decode_is_the_chunk1_prefill():
    """Decode at length n equals a 1-token chunk at start n-1."""
    q, kp, vp, _, _, pt = _inputs(40, B=2, Hkv=2, G=2)
    sl = np.asarray([11, 20], np.int32)
    dec = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(pt), _t(sl))
    for b in range(2):
        one = tpa.paged_prefill_attention(
            _t(q[b:b + 1, :, None]), _t(kp), _t(vp), _t(pt[b:b + 1]),
            _t(sl[b:b + 1]), int(sl[b]) - 1)
        np.testing.assert_allclose(one[0, :, 0].numpy(), dec[b].numpy(),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", [(2, 3, 5, 16), (1, 2, 8, 8),
                                   (3, 1, 1, 64)])
def test_q8_bit_equal(shape):
    """The int8 KV codec: identical int8 data and identical f32 scales."""
    x = np.random.default_rng(sum(shape)).normal(0, 2, shape) \
        .astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero slot hits the floor
    jq, js = jax_q8(jnp.asarray(x))
    tq, ts = torch_q8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_only_cpu_tensors_take_the_plain_version():
    """A tensor that is neither on the CPU nor on a card raises: the
    wrapper never falls back to the plain version for it."""
    q, kp, vp, _, _, pt = _inputs(50, B=1, Hkv=1, G=1)
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.paged_attention(_t(q).to("meta"), _t(kp).to("meta"),
                            _t(vp).to("meta"), torch.zeros((1, 4)),
                            torch.ones(1))
    before = tpa.paged_attention.launches
    tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(pt), torch.ones(1))
    assert tpa.paged_attention.launches == before, \
        "the plain version is not a launch"
