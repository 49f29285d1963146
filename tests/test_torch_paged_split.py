"""The split-K decode plan of the paged kernel, checked on the CPU (the
kernel itself runs only on the card):

* the planner (``_decode_splits``): every live slot of every row falls in
  exactly one split, splits are whole pages, none is empty of pages, a
  split holds at least ``_SPLIT_MIN_KEYS`` keys unless there is one, and
  the plan is a function of shapes alone: its constants are the kernel's
  ``constexpr``s, read from its source, and the wrapper plans and launches
  without reading a length on the host;
* the merge: a test-local split-and-merge in plain PyTorch over the
  planner's splits (each split's max, sum and weighted values, merged in
  split order, a split past the length skipped) against the Pallas kernel
  in interpret mode and against ``_paged_plain``, on the same numpy
  inputs, at n_split 1, 2, 3 and W, G 1 to 8, lengths 0, 1, ps and W * ps,
  float and int8 pools.

Tolerance: f32, atol 1e-5 / rtol 1e-5 (the order of the f32 sums only).
"""
import ctypes
import importlib
import inspect
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import _build

jpa = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")
tpa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")

SOURCE = Path(_build.KERNEL_DIR) / "paged_attention.cu"
ATOL = RTOL = 1e-5


def _constexpr(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE.name}"
    return int(m.group(1))


def test_plan_constants_match_the_kernel():
    assert tpa._SPLIT_MIN_KEYS == _constexpr("kSplitMinKeys")
    assert tpa._SPLIT_ITEMS_PER_SM == _constexpr("kSplitItemsPerSm")
    assert tpa._DECODE_MAX_GROUP == _constexpr("kDecodeMaxGroup")


def test_decode_route():
    """Decode at G <= 8 takes the split instance; a prefill chunk, or more
    query rows a kv head, the one-kernel instance."""
    for G in range(1, 9):
        assert tpa._decode_route(1, G)
    assert not tpa._decode_route(1, 9)
    assert not tpa._decode_route(256, 4)
    assert not tpa._decode_route(2, 1)


def _splits(n_split, pages, W):
    return [(s * pages, min((s + 1) * pages, W)) for s in range(n_split)]


@pytest.mark.parametrize("ps", [8, 16, 64, 128, 256, 1024])
def test_plan_covers_every_live_slot_once(ps):
    rng = np.random.default_rng(ps)
    for B in (1, 2, 8, 32, 64):
        for Hkv in (1, 2, 8, 32):
            for W in (1, 2, 3, 5, 16, 32, 256):
                for n_sm in (1, 8, 132):
                    n, pages = tpa._decode_splits(B, Hkv, W, ps, n_sm)
                    cols = _splits(n, pages, W)
                    # whole pages, in order, none empty, covering [0, W)
                    assert cols[0][0] == 0 and cols[-1][1] == W
                    assert all(a < b for a, b in cols)
                    assert all(cols[i][1] == cols[i + 1][0]
                               for i in range(n - 1))
                    if n > 1:
                        assert pages * ps >= tpa._SPLIT_MIN_KEYS
                    assert n <= max(1, -(-tpa._SPLIT_ITEMS_PER_SM * n_sm
                                         // (B * Hkv)))
                    # every live slot of a row in exactly one split
                    for n_keys in (0, 1, ps, W * ps,
                                   int(rng.integers(0, W * ps + 1))):
                        hits = np.zeros(W * ps, np.int64)
                        for a, b in cols:
                            hits[a * ps:min(b * ps, n_keys)] += 1
                        assert (hits[:n_keys] == 1).all()


def test_plan_fills_the_card_at_the_serve_shape():
    """Llama-3-8B decode in 8 slots of 2048 tokens (pages of 64) on 132
    SMs: at least two split items an SM, at least 256 keys a split."""
    n, pages = tpa._decode_splits(8, 8, 32, 64, 132)
    assert 8 * 8 * n >= 2 * 132
    assert pages * 64 >= 256
    assert (n, pages) == (8, 4)


class _Unreadable(torch.Tensor):
    """A tensor whose values the host must not read."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("item", "tolist", "numpy", "__bool__", "__int__",
                    "__index__", "__float__", "__array__"):
            raise AssertionError(f"the host read lens through {name}")
        return super().__torch_function__(func, types, args, kwargs or {})


def test_plan_reads_no_tensor_value(monkeypatch):
    """The planner takes shapes only, and the wrapper sizes the workspace
    and launches the decode instance with lengths whose values cannot be
    read on the host: the same plan for any lengths."""
    params = list(inspect.signature(tpa._decode_splits).parameters)
    assert params == ["B", "Hkv", "W", "ps", "n_sm"]

    calls = []

    def launch(lib, fn, dev, *args):
        ctypes.c_int.from_address(args[11]).value = 0   # reported: split
        calls.append(args)

    monkeypatch.setattr(tpa._build, "load", lambda name, sig: None)
    monkeypatch.setattr(tpa._build, "launch", launch)
    monkeypatch.setattr(tpa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(tpa, "_tickets",
                        lambda device, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    B, Hkv, G, D, P, ps, W = 2, 2, 4, 64, 17, 64, 8
    q4 = torch.zeros((B, Hkv, G, D))
    kp = torch.zeros((Hkv, P, ps, D))
    pt = torch.arange(1, 1 + B * W, dtype=torch.int32).reshape(B, W)
    for lens in ([0, 1], [256, 200], [5, 64]):
        sl = torch.tensor(lens, dtype=torch.int32).as_subclass(_Unreadable)
        tpa._launch_kernel(q4, kp, kp, pt, sl, None, 1, 0.125, None, None)
    n_split = [c[-4] for c in calls]
    assert n_split == [2, 2, 2] == [tpa._decode_splits(B, Hkv, W, ps,
                                                       132)[0]] * 3
    assert all(c[7] is None for c in calls), "decode passes no starts"


def _split_merge(q4, kp, vp, pt, lens, n_split, pages, sm_scale, ks, vs):
    """Flash-decoding in plain PyTorch: each live split's (m, l, acc) over
    its keys, merged in split order. A split past the length is not
    computed; a row with no live key is exactly 0."""
    B, Hkv, G, D = q4.shape
    ps = kp.shape[2]
    out = torch.zeros_like(q4)
    for b in range(B):
        n_keys = int(lens[b])
        n_live = min(-(-n_keys // (pages * ps)), n_split)
        parts = []
        for s in range(n_live):
            t = torch.arange(s * pages * ps, min((s + 1) * pages * ps,
                                                 n_keys))
            page, slot = pt[b, t // ps].long(), t % ps
            k = kp[:, page, slot].float()                  # (Hkv, n, D)
            v = vp[:, page, slot].float()
            if ks is not None:
                k = k * ks[:, page, slot][..., None]
                v = v * vs[:, page, slot][..., None]
            sc = torch.einsum("hgd,hnd->hgn", q4[b].float(), k) * sm_scale
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("hgn,hnd->hgd", p, v)))
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        acc = sum(torch.exp(m - M) * a for m, _, a in parts)
        den = sum(torch.exp(m - M) * l for m, l, _ in parts)
        out[b] = (acc / den.clamp_min(1e-20)).to(q4.dtype)
    return out


# (W, ps, n_sm) -> n_split, at B = 4, Hkv = 2
PLANS = {1: (4, 64, 1), 2: (4, 128, 100), 3: (3, 256, 6), "W": (4, 256, 100)}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("plan", list(PLANS))
def test_split_merge_matches_pallas_kernel(plan, G, quant):
    B, Hkv, D = 4, 2, 16
    W, ps, n_sm = PLANS[plan]
    n_split, pages = tpa._decode_splits(B, Hkv, W, ps, n_sm)
    assert n_split == (W if plan == "W" else plan)
    rng = np.random.default_rng(G + 10 * W + ps + 100 * quant)
    P = B * W + 1
    q = rng.normal(0, 1, (B, Hkv * G, D)).astype(np.float32)
    if quant:
        kp = rng.integers(-127, 128, (Hkv, P, ps, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (Hkv, P, ps, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (Hkv, P, ps)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (Hkv, P, ps)).astype(np.float32)
    else:
        kp = rng.normal(0, 1, (Hkv, P, ps, D)).astype(np.float32)
        vp = rng.normal(0, 1, (Hkv, P, ps, D)).astype(np.float32)
        ks = vs = None
    pt = rng.permutation(np.arange(1, P))[:B * W].reshape(B, W) \
        .astype(np.int32)
    # lengths 0 (a pad row on page 0), 1 and ps (splits wholly past them
    # when n_split > 1) and the whole table
    lens = np.asarray([0, 1, ps, W * ps], np.int32)
    pt[0] = 0
    j = (lambda a: None if a is None else jnp.asarray(a))
    t = (lambda a: None if a is None else torch.from_numpy(a))
    want = np.asarray(jpa.paged_attention(
        j(q), j(kp), j(vp), j(pt), j(lens), k_scales=j(ks),
        v_scales=j(vs)))
    sm_scale = 1.0 / math.sqrt(D)
    got = _split_merge(t(q).reshape(B, Hkv, G, D), t(kp), t(vp), t(pt),
                       lens, n_split, pages, sm_scale, t(ks), t(vs))
    got = got.reshape(B, Hkv * G, D).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    plain = tpa._paged_plain(t(q).reshape(B, Hkv, G, D), t(kp), t(vp),
                             t(pt), t(lens), None, 1, sm_scale, t(ks),
                             t(vs)).reshape(B, Hkv * G, D).numpy()
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)
    assert not got[0].any() and not want[0].any(), \
        "a length-0 row is exactly 0"
