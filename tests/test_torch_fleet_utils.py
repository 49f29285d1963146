"""``fleet.utils`` and ``fleet.meta_optimizers`` of the port against the JAX
package.

* ``recompute``: gradients (inputs and the parameters the segment closes
  over) equal to a run without recompute, bit for bit, with the same
  dropout masks (the default generator put back for the re-run) and the
  same later draws; against the reference's ``recompute`` on a
  deterministic segment within 1e-5 relative + 1e-6 absolute (f32: XLA's
  products and torch's sum in other orders);
  ``recompute_sequential`` over a ``Sequential`` equal to the plain
  backward; no graph is kept by the forward; ``preserve_rng_state=False``
  draws anew;
* ``internal_storage``: buckets pack and unpack bit-equal, their
  assignments and sizes the reference's, ``fused_all_reduce`` equal to
  the reference's on the same arrays;
* ``LocalFS``, and ``HDFSClient`` over a fake ``hadoop`` on ``PATH`` (the
  reference's test shim): the same answers as the reference's clients on
  the same calls;
* the three meta-optimizers around ``Momentum`` on two gloo ranks (one
  module-scoped world) against the reference's in one process, whose
  collectives are the identity: gradient merge rank by rank; local SGD
  and DGC against the mean over ranks of the reference's one-rank runs
  (with Momentum and fixed gradients the averaged run is that mean), at
  1e-6 relative + 1e-7 absolute;
* the exports: ``fleet.utils``, ``fleet.recompute`` (the module) and
  ``fleet.meta_optimizers``; ``HybridParallelInferenceHelper`` refused by
  name.
"""
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_dist_ranks as R
from paddle_tpu.core.tensor import Parameter as RefParameter
from paddle_tpu.core.tensor import Tensor as RefTensor
from paddle_tpu.distributed.fleet import meta_optimizers as ref_meta
from paddle_tpu.distributed.fleet.utils import fs as ref_fs
from paddle_tpu.distributed.fleet.utils import internal_storage as ref_st
from paddle_tpu.distributed.fleet.utils.recompute import \
    recompute as ref_recompute
from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.utils import fs as port_fs
from paddle_tpu_torch.distributed.fleet.utils import \
    internal_storage as port_st
from paddle_tpu_torch.distributed.fleet.utils.recompute import (
    recompute, recompute_sequential)
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-6, atol=1e-7)


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 8)).astype(np.float32),
            rng.standard_normal((8, 8)).astype(np.float32) * 0.5,
            rng.standard_normal((8, 3)).astype(np.float32),
            rng.standard_normal((5, 4)).astype(np.float32))


# --- recompute ----------------------------------------------------------------

def _port_run(use_recompute, seed=7):
    w1, w2, w3, x = (torch.from_numpy(a).requires_grad_(True)
                     for a in _weights())
    masks = []

    def segment(h):
        h = torch.tanh(h @ w2)
        y = F.dropout(h, p=0.5)
        masks.append((y == 0).clone())
        return y @ w3

    gen.seed(seed)
    h = torch.tanh(x @ w1)
    out = recompute(segment, h) if use_recompute else segment(h)
    loss = (out * out).sum()
    loss.backward()
    after = F.dropout(torch.ones(64), p=0.5)
    return ([t.grad.clone() for t in (x, w1, w2, w3)], masks, after,
            out.detach())


def test_recompute_equals_the_plain_backward_with_the_same_masks():
    grads, masks, after, out = _port_run(True)
    want_grads, want_masks, want_after, want_out = _port_run(False)
    assert torch.equal(out, want_out)
    for g, w in zip(grads, want_grads):
        assert torch.equal(g, w)
    # the forward's mask, then the re-run's: both the plain run's
    assert len(masks) == 2 and len(want_masks) == 1
    assert torch.equal(masks[0], want_masks[0])
    assert torch.equal(masks[1], want_masks[0])
    assert masks[0].any() and not masks[0].all()
    assert torch.equal(after, want_after)


def test_recompute_without_preserving_the_rng_draws_anew():
    w = torch.ones(4, 4, requires_grad=True)
    masks = []

    def segment(h):
        y = F.dropout(h @ w, p=0.5)
        masks.append(y == 0)
        return y

    gen.seed(3)
    recompute(segment, torch.ones(16, 4), preserve_rng_state=False) \
        .sum().backward()
    assert not torch.equal(masks[0], masks[1])


def test_recompute_keeps_no_graph_in_the_forward():
    w = torch.ones(4, 4, requires_grad=True)
    out = recompute(lambda h: torch.tanh(h @ w), torch.ones(2, 4))
    assert type(out.grad_fn).__name__ == "_RecomputeBackward"
    assert len(out.grad_fn.next_functions) <= 2
    out.sum().backward()
    assert w.grad is not None
    with torch.no_grad():
        assert recompute(lambda h: h @ w, torch.ones(2, 4)).grad_fn is None


def test_recompute_matches_the_reference():
    """Within 1e-5 relative + 1e-6 absolute: XLA's f32 products and
    torch's sum in other orders."""
    w1, w2, w3, x = _weights(1)
    rw = [RefParameter(jnp.asarray(a)) for a in (w1, w2, w3)]
    rx = RefTensor(jnp.asarray(x), stop_gradient=False)

    def ref_segment(h):
        return paddle.matmul(paddle.tanh(paddle.matmul(h, rw[1])), rw[2])

    rout = ref_recompute(ref_segment, paddle.tanh(paddle.matmul(rx, rw[0])))
    (rout * rout).sum().backward()
    want = [np.asarray(t.grad._value) for t in (rx, *rw)]

    tw = [torch.from_numpy(a).requires_grad_(True) for a in (w1, w2, w3)]
    tx = torch.from_numpy(x).requires_grad_(True)
    out = recompute(lambda h: torch.tanh(h @ tw[1]) @ tw[2],
                    torch.tanh(tx @ tw[0]))
    (out * out).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(rout._value), **tol)
    for g, w in zip((tx, *tw), want):
        np.testing.assert_allclose(g.grad.numpy(), w, **tol)


def test_recompute_sequential_equals_the_plain_backward():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import place
    prev = place._default
    place.set_device("cpu")
    try:
        net = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 8),
                            nn.Tanh(), nn.Linear(8, 2))
    finally:
        place._default = prev
    x = torch.from_numpy(_weights()[3])
    grads = []
    for use in (True, False):
        for p in net.parameters():
            p.grad = None
        xi = x.clone().requires_grad_(True)
        out = recompute_sequential({"segments": 2}, net, xi) if use \
            else net(xi)
        out.pow(2).sum().backward()
        grads.append([xi.grad.clone()] + [p.grad.clone()
                                          for p in net.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# --- internal_storage ---------------------------------------------------------

def _mixed(seed=4):
    rng = np.random.default_rng(seed)
    shapes = [(3, 5), (7,), (2, 2, 2), (40,), (1,), (6, 6)]
    dtypes = [np.float32, np.float32, np.float16, np.float32, np.float16,
              np.float32]
    return [rng.standard_normal(s).astype(d) for s, d in zip(shapes, dtypes)]


@pytest.mark.parametrize("budget", [64, 200, 10 ** 6])
def test_buckets_pack_unpack_bit_equal_and_match_the_reference(budget):
    arrays = _mixed()
    port = port_st.GradStorage(budget)
    buckets = port.build([torch.from_numpy(a) for a in arrays])
    ref = ref_st.GradStorage(budget)
    ref_buckets = ref.build([jnp.asarray(a) for a in arrays])
    assert port.assignments == ref.assignments
    assert [b.numel for b in buckets] == [b.numel for b in ref_buckets]
    for b, rb in zip(buckets, ref_buckets):
        flat = b.pack()
        np.testing.assert_array_equal(flat.numpy(), np.asarray(rb.pack()))
        for t, u in zip(b.tensors, b.unpack(flat)):
            assert torch.equal(t, u) and t.dtype == u.dtype
    got = port_st.fused_all_reduce([torch.from_numpy(a) for a in arrays],
                                   lambda f: f * 3, budget)
    want = ref_st.fused_all_reduce([jnp.asarray(a) for a in arrays],
                                   lambda f: f * 3, budget)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tensors = [torch.from_numpy(a.copy()) for a in arrays]
    port_st.reduce_in_place(tensors, lambda f: f * 3, budget)
    for t, w in zip(tensors, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


# --- fs -----------------------------------------------------------------------

FAKE_HADOOP = r"""#!/bin/bash
# Minimal `hadoop fs` emulation over $FAKE_HDFS_ROOT.
shift  # drop "fs"
while [ "$1" = "-D" ]; do shift 2; done  # skip -D k=v config pairs
cmd="$1"; shift
root="${FAKE_HDFS_ROOT:?}"
p() { echo "$root/${1#/}"; }
case "$cmd" in
  -test)
    flag="$1"; path="$(p "$2")"
    case "$flag" in
      -d) [ -d "$path" ] ;;
      -e) [ -e "$path" ] ;;
      *) exit 2 ;;
    esac ;;
  -ls)
    path="$(p "$1")"
    [ -e "$path" ] || exit 1
    echo "Found $(ls "$path" | wc -l) items"
    for e in "$path"/*; do
      [ -e "$e" ] || continue
      if [ -d "$e" ]; then perm="drwxr-xr-x"; else perm="-rw-r--r--"; fi
      echo "$perm 1 u g 0 2026-01-01 00:00 $1/$(basename "$e")"
    done ;;
  -mkdir) shift; mkdir -p "$(p "$1")" ;;
  -put) src="$1"; cp "$src" "$(p "$2")" ;;
  -get) cp "$(p "$1")" "$2" ;;
  -mv) mv "$(p "$1")" "$(p "$2")" ;;
  -rm) shift; rm -rf "$(p "$1")" ;;
  -touchz) touch "$(p "$1")" ;;
  -cat) cat "$(p "$1")" ;;
  *) echo "unknown cmd $cmd" >&2; exit 1 ;;
esac
"""


def _drive(mod, client, local, root):
    """The same calls on one package's client under ``root``; the
    answers."""
    out = []
    tag = os.path.basename(root)
    d = f"{root}/a/b"
    client.mkdirs(d)
    out.append((client.is_dir(d), client.is_exist(d), client.is_file(d)))
    src = os.path.join(local, f"{tag}_src.txt")
    with open(src, "w") as f:
        f.write("hello fleet")
    client.upload(src, f"{d}/x.txt")
    client.touch(f"{d}/empty")
    out.append(client.ls_dir(d))
    out.append(client.cat(f"{d}/x.txt"))
    try:
        client.touch(f"{d}/empty", exist_ok=False)
    except mod.FSFileExistsError as e:
        out.append(("exists", type(e).__name__))
    client.mv(f"{d}/x.txt", f"{d}/y.txt")
    try:
        client.mv(f"{d}/empty", f"{d}/y.txt")
    except mod.FSFileExistsError:
        out.append("mv refused")
    client.mv(f"{d}/empty", f"{d}/y.txt", overwrite=True)
    dst = os.path.join(local, f"{tag}_dl", "y.txt")
    client.download(f"{d}/y.txt", dst)
    out.append(os.path.getsize(dst))
    out.append(client.list_dirs(f"{root}/a"))
    client.delete(f"{root}/a")
    out.append((client.is_exist(d), client.ls_dir(f"{root}/a")))
    out.append(client.need_upload_download())
    return out


@pytest.fixture
def fake_hadoop(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    sh = bindir / "hadoop"
    sh.write_text(FAKE_HADOOP)
    sh.chmod(sh.stat().st_mode | stat.S_IEXEC)
    root = tmp_path / "hdfs"
    root.mkdir()
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_HDFS_ROOT", str(root))
    return root


def test_hdfs_client_matches_the_reference(fake_hadoop, tmp_path):
    got = _drive(port_fs, port_fs.HDFSClient(sleep_inter=0), str(tmp_path),
                 "/port")
    want = _drive(ref_fs, ref_fs.HDFSClient(sleep_inter=0), str(tmp_path),
                  "/ref")
    assert got == want
    assert got[1] == ([], ["empty", "x.txt"])
    client = port_fs.HDFSClient(sleep_inter=0)
    assert client.cat("/port/nothing") == \
        ref_fs.HDFSClient(sleep_inter=0).cat("/port/nothing") == ""


def test_hdfs_client_without_hadoop_raises_execute_error(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(port_fs.ExecuteError, match="hadoop binary"):
        port_fs.HDFSClient(sleep_inter=0).mkdirs("/x")


def test_local_fs_matches_the_reference(tmp_path):
    got = _drive(port_fs, port_fs.LocalFS(), str(tmp_path),
                 str(tmp_path / "port"))
    want = _drive(ref_fs, ref_fs.LocalFS(), str(tmp_path),
                  str(tmp_path / "ref"))
    assert got == want


# --- meta_optimizers -----------------------------------------------------------

LR, MOMENTUM, K_STEPS, SPARSITY, STEPS = 0.1, 0.9, 2, 0.75, 4


def _meta_inputs():
    rng = np.random.default_rng(9)
    init = [rng.standard_normal(s).astype(np.float32)
            for s in ((4, 3), (5,))]
    grads = [[[rng.standard_normal(a.shape).astype(np.float32)
               for a in init] for _ in range(STEPS)] for _ in range(2)]
    return init, grads


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    init, grads = _meta_inputs()
    return R.run_world(tmp_path_factory.mktemp("fleet_utils"), 2, [
        ("meta", "meta_optimizers", dict(init=init, grads=grads, lr=LR,
                                         momentum=MOMENTUM, k_steps=K_STEPS,
                                         sparsity=SPARSITY))])


def _ref_run(name, init, rank_grads):
    from paddle_tpu import optimizer as ref_opt
    params = [RefParameter(jnp.asarray(a)) for a in init]
    inner = ref_opt.Momentum(learning_rate=LR, momentum=MOMENTUM,
                             parameters=params)
    opt = {"gradient_merge": lambda: ref_meta.GradientMergeOptimizer(
               inner, K_STEPS),
           "local_sgd": lambda: ref_meta.LocalSGDOptimizer(inner, K_STEPS),
           "dgc": lambda: ref_meta.DGCMomentumOptimizer(
               inner, sparsity=SPARSITY)}[name]()
    seen = []
    for step_grads in rank_grads:
        for p, g in zip(params, step_grads):
            p._grad = RefTensor(jnp.asarray(g))
        opt.step()
        opt.clear_grad()
        seen.append([np.asarray(p._value) for p in params])
    return seen


@pytest.mark.parametrize("name", ["gradient_merge", "local_sgd", "dgc"])
def test_meta_optimizers_match_the_reference_on_two_ranks(world, name):
    init, grads = _meta_inputs()
    outs = [r["meta"] for r in world]
    for r, o in enumerate(outs):
        assert "error" not in o, o.get("error")
    assert all(r["_loaded"] == [] for r in world)
    refs = [_ref_run(name, init, grads[r]) for r in range(2)]
    for r in range(2):
        for s in range(STEPS):
            if name == "gradient_merge":
                want = refs[r][s]
            elif name == "local_sgd" and (s + 1) % K_STEPS:
                continue      # between averages the ranks differ
            else:
                want = [(a + b) / 2 for a, b in zip(refs[0][s], refs[1][s])]
            for got, w in zip(outs[r][name][s], want):
                np.testing.assert_allclose(got, w, **TOL,
                                           err_msg=f"rank {r} step {s}")
    if name != "gradient_merge":
        for s in range(K_STEPS - 1, STEPS, K_STEPS):
            for a, b in zip(outs[0][name][s],
                            outs[1][name][s]):
                np.testing.assert_array_equal(a, b)


def test_fleet_exports_utils_recompute_and_meta_optimizers():
    import paddle_tpu.distributed.fleet as ref_fleet
    assert fleet.recompute is fleet.utils.recompute
    assert type(fleet.recompute).__name__ == type(ref_fleet.recompute) \
        .__name__ == "module"
    assert fleet.utils.recompute_fn is recompute
    for name in ("FS", "LocalFS", "HDFSClient", "TensorBucket",
                 "GradStorage", "ParamStorage", "fused_all_reduce",
                 "internal_storage", "fs"):
        assert hasattr(fleet.utils, name) and hasattr(ref_fleet.utils, name)
    for name in ("GradientMergeOptimizer", "LocalSGDOptimizer",
                 "DGCMomentumOptimizer"):
        assert hasattr(fleet.meta_optimizers, name)
    with pytest.raises(NotImplementedError, match="15.4"):
        fleet.utils.HybridParallelInferenceHelper
    with pytest.raises(NotImplementedError, match="item 15"):
        fleet.heter
