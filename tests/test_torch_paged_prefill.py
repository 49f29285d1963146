"""The tensor-core prefill instance of the paged kernel, checked on the CPU
(the kernel itself, and its route, ``paged_attention_instance``, run only
on the card; tests/test_torch_kernels_cuda.py holds the route there):

* the launch: the wrapper passes a prefill chunk to the kernel without
  reading a length on the host, and counts it under the instance that the
  kernel's entry reports;
* the arithmetic: a test-local emulation of the instance in plain
  PyTorch (64-key tiles, the scores scaled in f32 by sm_scale * log2(e),
  the int8 key scale folded on the score's column and the value scale on
  p's, an online softmax in base 2, p split into hi = bf16(p) and lo =
  bf16(p - hi) for P.V) against the Pallas kernel in interpret mode and
  against ``_paged_plain`` on the same numpy inputs (q and pools in bf16),
  at G 1/3/4, pages of 8/16/64 slots (8 the smallest page the instance
  takes), bf16 and int8 pools, a row of length
  0, a row shorter than start + C, and bad page ids (against
  ``_paged_plain`` alone, whose tables must hold valid ids).

Tolerance: ``PAGED_TOL`` of chip_smoke.py for a bf16 output, 1e-4 +
2^-7·|want|: both sides round an f32 value to bf16 once (one ulp, 2^-8 of
|want|, at most), and p's two bf16 parts keep it to about 2^-17. With one
bf16 rounding of p instead, an output near 0 is off by about 1e-3 /
sqrt(live keys), past the 1e-4 the limit leaves there:
``test_split_of_p_keeps_the_paged_limit`` prints both readings (``-s``).
"""
import ctypes
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jpa = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")
tpa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")

ATOL, RTOL = 1e-4, 2 ** -7        # chip_smoke.py's PAGED_TOL, bf16 out
LOG2E = 1.4426950408889634
KEYS = 64                         # keys a tile of the instance
NEG_INF = -1e30


class _Unreadable(torch.Tensor):
    """A tensor whose values the host must not read."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("item", "tolist", "numpy", "__bool__", "__int__",
                    "__index__", "__float__", "__array__"):
            raise AssertionError(f"the host read a length through {name}")
        return super().__torch_function__(func, types, args, kwargs or {})


def test_prefill_launch_reads_no_tensor_value(monkeypatch):
    """The wrapper passes a prefill chunk to the kernel (chunk, rows,
    starts and the bf16 / int8 codes) with lengths and starts whose values
    the host cannot read, and counts one launch under the instance the
    kernel's entry reports through its out-parameter."""
    calls = []

    def launch(lib, fn, dev, *args):
        ctypes.c_int.from_address(args[11]).value = 1   # reported: mma
        calls.append(args)

    monkeypatch.setattr(tpa._build, "load", lambda name, sig: None)
    monkeypatch.setattr(tpa._build, "launch", launch)
    B, Hkv, G, C, D, P, ps, W = 2, 2, 4, 32, 64, 17, 16, 8
    q4 = torch.zeros((B, Hkv, G * C, D), dtype=torch.bfloat16)
    pt = torch.arange(1, 1 + B * W, dtype=torch.int32).reshape(B, W)
    before = tpa.paged_attention.launches
    by_instance = dict(tpa.paged_attention.instance_launches)
    for kv in (torch.bfloat16, torch.int8):
        kp = torch.zeros((Hkv, P, ps, D), dtype=kv)
        sc = (torch.ones((Hkv, P, ps)),) * 2 if kv == torch.int8 \
            else (None, None)
        sl = torch.tensor([40, 7], dtype=torch.int32) \
            .as_subclass(_Unreadable)
        st = torch.tensor([8, 8], dtype=torch.int32) \
            .as_subclass(_Unreadable)
        tpa._launch_kernel(q4, kp, kp, pt, sl, st, C, 0.125, *sc)
    assert tpa.paged_attention.launches == before + 2
    by_instance["mma"] += 2
    assert tpa.paged_attention.instance_launches == by_instance
    for c, kv in zip(calls, (1, 2)):
        # ..., instance, B, Hkv, R, D, P, ps, W, chunk, n_split, scale, q,
        # kv codes
        assert c[12:19] == (B, Hkv, G * C, D, P, ps, W)
        assert c[19] == C and c[20] == 0
        assert c[-2:] == (1, kv)
        assert c[7] is not None, "prefill passes its starts"


# --- the instance's arithmetic, emulated ------------------------------------

def _mma_emulation(q4, kp, vp, pt, lens, starts, chunk, sm_scale, ks=None,
                   vs=None, split=True):
    """The prefill instance's arithmetic in plain PyTorch, f32: for each
    64-key tile of the table, S = q . K (bf16 operands, f32 sums) times
    the key scale, times sm_scale * log2(e); masked causally by absolute
    position, by the length and by page validity (an id outside [0, P)
    reads nothing); an online softmax in base 2 with m and l in f32; p
    times the value scale, then O = alpha * O + hi . V + lo . V with hi =
    bf16(p), lo = bf16(p - hi) (``split``; else bf16(p) . V alone); out =
    O / max(l, 1e-20) in q's dtype."""
    B, Hkv, R, D = q4.shape
    _, P, ps, _ = kp.shape
    W = pt.shape[1]
    scale_log2 = torch.tensor(sm_scale * LOG2E, dtype=torch.float32)
    out = torch.zeros(q4.shape, dtype=torch.float32)
    for b in range(B):
        q = q4[b].float()                                    # (Hkv, R, D)
        pos = int(starts[b]) + torch.arange(R) % chunk
        m = torch.full((Hkv, R), NEG_INF)
        l = torch.zeros((Hkv, R))
        acc = torch.zeros((Hkv, R, D))
        for k0 in range(0, W * ps, KEYS):
            keys = k0 + torch.arange(KEYS)
            col = keys // ps
            page = torch.where(col < W, pt[b, col.clamp_max(W - 1)].long(),
                               -1)
            ok = (page >= 0) & (page < P)
            pg, slot = page.clamp(0, P - 1), keys % ps
            k = kp[:, pg, slot].float() * ok[None, :, None]  # zeros if bad
            v = vp[:, pg, slot].float() * ok[None, :, None]
            s = torch.einsum("hrd,hkd->hrk", q, k)
            if ks is not None:
                s = s * (ks[:, pg, slot] * ok)[:, None, :]
            s = s * scale_log2
            live = (ok[None, :] & (keys[None, :] < int(lens[b]))
                    & (keys[None, :] <= pos[:, None]))       # (R, 64)
            s = torch.where(live[None], s, torch.tensor(NEG_INF))
            mn = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mn)
            p = torch.where(live[None], torch.exp2(s - mn[..., None]),
                            torch.tensor(0.0))
            l = alpha * l + p.sum(-1)
            m = mn
            if vs is not None:
                p = p * (vs[:, pg, slot] * ok)[:, None, :]
            hi = p.to(torch.bfloat16).float()
            pv = torch.einsum("hrk,hkd->hrd", hi, v)
            if split:
                lo = (p - hi).to(torch.bfloat16).float()
                pv = pv + torch.einsum("hrk,hkd->hrd", lo, v)
            acc = alpha[..., None] * acc + pv
        out[b] = acc / l.clamp_min(1e-20)[..., None]
    return out.to(q4.dtype)


def _bf16(a):
    """numpy f32 -> the same values rounded to bf16, still f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(seed, B, Hkv, G, C, D, P, ps, W, quant):
    rng = np.random.default_rng(seed)
    q = _bf16(rng.normal(0, 1, (B, Hkv * G, C, D)).astype(np.float32))
    if quant:
        kp = rng.integers(-127, 128, (Hkv, P, ps, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (Hkv, P, ps, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (Hkv, P, ps)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (Hkv, P, ps)).astype(np.float32)
    else:
        kp = _bf16(rng.normal(0, 1, (Hkv, P, ps, D)).astype(np.float32))
        vp = _bf16(rng.normal(0, 1, (Hkv, P, ps, D)).astype(np.float32))
        ks = vs = None
    pt = rng.permutation(np.arange(1, P))[:B * W].reshape(B, W) \
        .astype(np.int32)
    return q, kp, vp, ks, vs, pt


def _torch(a, bf16=False):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if bf16 else t


def _ratio(got, want):
    """The largest |got - want| / (ATOL + RTOL·|want|), element by
    element, both taken in f32."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(g - w) / (ATOL + RTOL * np.abs(w))).max())


def _run(q, kp, vp, ks, vs, pt, lens, start, G, split=True):
    """The emulation's output, (B, Hq, C, D) f32 numpy, and sm_scale."""
    B, Hq, C, D = q.shape
    Hkv = kp.shape[0]
    quant = ks is not None
    q4 = _torch(q, True).reshape(B, Hkv, G * C, D)
    kpt, vpt = _torch(kp, not quant), _torch(vp, not quant)
    sl = torch.from_numpy(np.asarray(lens, np.int32))
    st = torch.full((B,), start, dtype=torch.int32)
    sm_scale = 1.0 / math.sqrt(D)
    emu = _mma_emulation(q4, kpt, vpt, torch.from_numpy(pt), sl, st, C,
                         sm_scale, _torch(ks), _torch(vs), split=split)
    return emu.float().reshape(q.shape).numpy(), sm_scale


@pytest.mark.parametrize("start", [0, 100])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("G", [1, 3, 4])
def test_emulation_matches_pallas_kernel_and_plain(G, ps, quant, start):
    """A 20-token chunk at start 0 or 100 over 128 keys of table (two
    64-key tiles): row 0 of length 0 (a pad row on page 0: exactly 0), row
    1 shorter than start + C, row 2 at start + C."""
    B, Hkv, C, D = 3, 2, 20, 64
    W = 128 // ps
    P = B * W + 1
    q, kp, vp, ks, vs, pt = _inputs(G + 10 * ps + quant + start, B, Hkv,
                                    G, C, D, P, ps, W, quant)
    lens = np.asarray([0, start + C - 7, start + C], np.int32)
    pt[0] = 0
    got, sm_scale = _run(q, kp, vp, ks, vs, pt, lens, start, G)
    jb = (lambda a: None if a is None else jnp.asarray(a))
    want = np.asarray(jpa.paged_prefill_attention(
        jnp.asarray(q).astype(jnp.bfloat16),
        jb(kp) if quant else jnp.asarray(kp).astype(jnp.bfloat16),
        jb(vp) if quant else jnp.asarray(vp).astype(jnp.bfloat16),
        jnp.asarray(pt), jnp.asarray(lens), start, k_scales=jb(ks),
        v_scales=jb(vs)).astype(jnp.float32))
    assert _ratio(got, want) <= 1.0
    plain = tpa._paged_plain(
        _torch(q, True).reshape(B, Hkv, G * C, D),
        _torch(kp, not quant), _torch(vp, not quant), torch.from_numpy(pt),
        torch.from_numpy(lens), torch.full((B,), start, dtype=torch.int32),
        C, sm_scale, _torch(ks), _torch(vs)).float().reshape(q.shape)
    assert _ratio(got, plain.numpy()) <= 1.0
    assert not got[0].any() and not want[0].any(), \
        "a length-0 row is exactly 0"


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ps", [16, 64])
def test_emulation_reads_nothing_from_bad_pages(ps, quant):
    """Row 1's last page id is past the pool (P + 3) and row 2's are all
    -1: their keys are dead, so the answer is the plain version's with
    row 1 cut before that page and row 2 of length 0 (exactly 0)."""
    B, Hkv, G, C, D, start = 3, 2, 4, 24, 64, 40
    W = 128 // ps
    P = B * W + 1
    q, kp, vp, ks, vs, pt = _inputs(7 + ps + quant, B, Hkv, G, C, D, P,
                                    ps, W, quant)
    lens = np.asarray([start + C, W * ps, start + C], np.int32)
    want_pt, want_lens = pt.copy(), lens.copy()
    pt[1, -1] = P + 3
    want_lens[1] = (W - 1) * ps
    pt[2] = -1
    want_lens[2] = 0
    got, sm_scale = _run(q, kp, vp, ks, vs, pt, lens, start, G)
    plain = tpa._paged_plain(
        _torch(q, True).reshape(B, Hkv, G * C, D),
        _torch(kp, not quant), _torch(vp, not quant),
        torch.from_numpy(want_pt), torch.from_numpy(want_lens),
        torch.full((B,), start, dtype=torch.int32), C, sm_scale,
        _torch(ks), _torch(vs)).float().reshape(q.shape).numpy()
    assert _ratio(got, plain) <= 1.0
    assert not got[2].any(), "a row whose pages are all bad is exactly 0"


@pytest.mark.parametrize("quant", [False, True])
def test_split_of_p_keeps_the_paged_limit(quant, capsys):
    """At the serve shape's chunk (8 kv heads, G = 4, D = 128, C = 256 at
    start 512 over 712 keys of pages of 64): the split p stays within the
    limit; one bf16 rounding of p does not, where outputs lie near 0.
    Prints both largest err/limit readings (PERF.md records them)."""
    B, Hkv, G, C, D, ps, W, start = 1, 8, 4, 256, 128, 64, 12, 512
    P = W + 1
    q, kp, vp, ks, vs, pt = _inputs(11 + quant, B, Hkv, G, C, D, P, ps, W,
                                    quant)
    lens = np.asarray([start + 200], np.int32)
    split, sm_scale = _run(q, kp, vp, ks, vs, pt, lens, start, G)
    single, _ = _run(q, kp, vp, ks, vs, pt, lens, start, G, split=False)
    plain = tpa._paged_plain(
        _torch(q, True).reshape(B, Hkv, G * C, D),
        _torch(kp, not quant), _torch(vp, not quant), torch.from_numpy(pt),
        torch.from_numpy(lens), torch.full((B,), start, dtype=torch.int32),
        C, sm_scale, _torch(ks), _torch(vs)).float().reshape(q.shape).numpy()
    r_split, r_single = _ratio(split, plain), _ratio(single, plain)
    with capsys.disabled():
        print(f"\n[paged prefill emulation, {'int8' if quant else 'bf16'} "
              f"pools] largest err/limit: p split {r_split:.4f}, "
              f"p rounded once {r_single:.4f}")
    assert r_split <= 1.0
    assert r_single > 1.0, "one rounding of p would break the limit"
