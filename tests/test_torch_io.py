"""``paddle.io``, ``paddle.save`` / ``paddle.load``, ``paddle.device`` and
the autotune cache of the PyTorch port against the JAX package's:

* the datasets and ``DataLoader``'s batches equal to the reference's for a
  ``SequenceSampler``, an explicit ``batch_sampler`` and a shuffled
  ``DistributedBatchSampler`` (numpy's shuffle: exact), on the
  synchronous, thread and shared-memory paths; the samplers that draw from
  the generator (``RandomSampler``, ``WeightedRandomSampler``,
  ``random_split``), whose numbers differ from the reference's threefry
  draws, held by their properties and their repeatability from
  ``paddle.seed``;
* the shared-memory worker processes: order, several epochs, a worker's
  exception in the parent, persistent workers reused, ``worker_init_fn``,
  tensor datasets kept on threads; the ring's round trip, wraparound and
  oversize error; ``NativeBatchAssembler``. Nothing here depends on which
  worker serves which batch or when;
* files crossing ``save`` / ``load`` both ways, bit for bit (float32,
  int32, bfloat16 with and without ``ml_dtypes``), ``return_numpy``, the
  atomic write;
* ``device`` and ``custom_device`` on a machine without a card;
* ``AutoTuneCache``'s key, export and load against the reference's.

The reference's traps that this slice copies are named here
(``get_worker_info``, the iterable path's ``num_workers``, ``timeout``).
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as rp
from paddle_tpu import io as rio
from paddle_tpu.ops import autotune as ref_autotune
import paddle_tpu_torch as tp
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import place
from paddle_tpu_torch.framework import custom_device, device
from paddle_tpu_torch.io import native_loader, shm_channel
from paddle_tpu_torch.ops import autotune

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def on_cpu():
    prev = place._default
    tp.set_device("cpu")
    yield
    place._default = prev


def _rows(n=23, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, 5)).astype(np.float32),
            rng.integers(0, 7, n).astype(np.int64))


def _dataset(io, n=23, seed=0):
    x, y = _rows(n, seed)

    class Rows(io.Dataset):
        def __getitem__(self, i):
            return {"x": x[i], "meta": (np.int64(i), float(i) / 2)}, y[i]

        def __len__(self):
            return n

    return Rows()


def _host(b):
    if isinstance(b, dict):
        return {k: _host(v) for k, v in b.items()}
    if isinstance(b, (list, tuple)):
        return [_host(v) for v in b]
    if isinstance(b, torch.Tensor):
        return b.numpy()
    return np.asarray(b.numpy() if hasattr(b, "numpy") else b)


def _flat(b):
    if isinstance(b, dict):
        return [a for k in sorted(b) for a in _flat(b[k])]
    if isinstance(b, (list, tuple)):
        return [a for v in b for a in _flat(v)]
    return [b]


def _same(got, want):
    g, w = _flat(_host(got)), _flat(_host(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _epoch(loader):
    return [_host(b) for b in loader]


# ---- datasets --------------------------------------------------------------

def test_datasets_against_the_reference():
    x, y = _rows()
    for io in (rio, tio):
        assert len(io.TensorDataset([x, y])) == 23
    pt, rf = tio.TensorDataset([x, y]), rio.TensorDataset([x, y])
    for i in (0, 7, 22):
        _same(pt[i], rf[i])
    sub = (tio.Subset(pt, [5, 1, 9]), rio.Subset(rf, [5, 1, 9]))
    _same([sub[0][i] for i in range(3)], [sub[1][i] for i in range(3)])
    cat = (tio.ConcatDataset([pt, sub[0]]), rio.ConcatDataset([rf, sub[1]]))
    assert len(cat[0]) == len(cat[1]) == 26
    _same([cat[0][i] for i in (0, 22, 23, 25)],
          [cat[1][i] for i in (0, 22, 23, 25)])
    comp = (tio.ComposeDataset([pt, pt]), rio.ComposeDataset([rf, rf]))
    _same(comp[0][4], comp[1][4])
    with pytest.raises(ValueError, match="same length"):
        tio.ComposeDataset([pt, sub[0]])
    chain = (list(iter(tio.ChainDataset([range(3), range(2)]))),
             list(iter(rio.ChainDataset([range(3), range(2)]))))
    assert chain[0] == chain[1] == [0, 1, 2, 0, 1]
    # the trap: list() asks for a length hint, and IterableDataset's
    # __len__ raises RuntimeError (not TypeError), in both packages
    for io in (rio, tio):
        with pytest.raises(RuntimeError, match="no len"):
            list(io.ChainDataset([range(3)]))
    # a torch tensor in a TensorDataset gives its row as a tensor
    t = torch.arange(12).reshape(6, 2)
    assert torch.equal(tio.TensorDataset([t])[3][0], t[3])
    for io in (rio, tio):
        with pytest.raises(RuntimeError):
            io.IterableDataset()[0]


@pytest.mark.parametrize("collate_case", ["ndarray", "scalars", "nested"])
def test_default_collate_fn_against_the_reference(collate_case):
    rng = np.random.default_rng(3)
    batch = {
        "ndarray": [rng.standard_normal(4).astype(np.float32)
                    for _ in range(3)],
        "scalars": [1, 2, 3],
        "nested": [({"a": np.int64(i)}, 0.5 * i, [i, -i]) for i in range(3)],
    }[collate_case]
    _same(tio.default_collate_fn(batch), rio.default_collate_fn(batch))


# ---- samplers and batches --------------------------------------------------

@pytest.mark.parametrize("workers,shared", [(0, True), (2, False),
                                            (3, True)])
def test_loader_batches_equal_the_reference(workers, shared):
    """Sequence sampler, explicit batch sampler and a shuffled
    distributed sampler (rank 1 of 3), on each path."""
    ref_ds, port_ds = _dataset(rio), _dataset(tio)
    cases = [
        dict(batch_size=5, drop_last=False),
        dict(batch_sampler=("batch", 4, True)),
        dict(batch_sampler=("dist", 3, True)),
    ]
    for case in cases:
        kw = dict(case)
        loaders = []
        for io, ds in ((rio, ref_ds), (tio, port_ds)):
            bs = kw.get("batch_sampler")
            k = {key: v for key, v in kw.items() if key != "batch_sampler"}
            if bs and bs[0] == "batch":
                k["batch_sampler"] = io.BatchSampler(
                    sampler=io.SequenceSampler(ds), batch_size=bs[1],
                    drop_last=bs[2])
            elif bs:
                s = io.DistributedBatchSampler(ds, bs[1], num_replicas=3,
                                               rank=1, shuffle=True)
                s.set_epoch(4)
                k["batch_sampler"] = s
            loaders.append(io.DataLoader(
                ds, num_workers=workers if io is tio else 0,
                use_shared_memory=shared, **k))
        want, got = _epoch(loaders[0]), _epoch(loaders[1])
        assert len(want) == len(got) == len(loaders[1])
        for g, w in zip(got, want):
            _same(g, w)


def test_distributed_sampler_pads_and_partitions_as_the_reference():
    ds = _dataset(tio, n=10)
    for shuffle in (False, True):
        for rank in range(4):
            got = list(tio.DistributedBatchSampler(
                ds, 2, num_replicas=4, rank=rank, shuffle=shuffle))
            want = list(rio.DistributedBatchSampler(
                _dataset(rio, n=10), 2, num_replicas=4, rank=rank,
                shuffle=shuffle))
            assert got == want
    s = tio.DistributedBatchSampler(ds, 2, num_replicas=4, rank=0,
                                    drop_last=True)
    assert len(s) == 1 and len(list(s)) == 1


def test_generator_samplers_by_their_properties():
    """RandomSampler, WeightedRandomSampler and random_split draw from the
    port's generator: the reference's threefry numbers are not theirs, so
    they are held by what they must be, and repeat from paddle.seed."""
    ds = _dataset(tio, n=31)

    def draws():
        tp.seed(11)
        return (list(tio.RandomSampler(ds)),
                list(tio.RandomSampler(ds, replacement=True,
                                       num_samples=50)),
                list(tio.WeightedRandomSampler([0, 1, 3, 0, 2], 40)),
                list(tio.WeightedRandomSampler([1, 1, 1, 1], 4,
                                               replacement=False)),
                [s.indices for s in tio.random_split(ds, [10, 21])])

    perm, repl, weighted, no_repl, split = draws()
    assert sorted(perm) == list(range(31)) and perm != list(range(31))
    assert len(tio.RandomSampler(ds)) == 31
    assert len(repl) == 50 and all(0 <= i < 31 for i in repl)
    assert len(weighted) == 40 and set(weighted) <= {1, 2, 4}
    assert weighted.count(2) > weighted.count(1)
    assert sorted(no_repl) == [0, 1, 2, 3]
    assert len(split[0]) == 10 and sorted(split[0] + split[1]) == list(
        range(31))
    assert draws() == (perm, repl, weighted, no_repl, split)
    tp.seed(12)
    assert list(tio.RandomSampler(ds)) != perm
    # the reference's sampler gives a permutation too, of other numbers
    ref = list(rio.RandomSampler(_dataset(rio, n=31)))
    assert sorted(ref) == list(range(31))
    # a shuffled loader: every sample once per epoch
    loader = tio.DataLoader(ds, batch_size=4, shuffle=True)
    seen = np.concatenate([b[0]["meta"][0].numpy() for b in loader])
    assert sorted(seen.tolist()) == list(range(31))


def test_batches_land_on_the_loader_device_with_the_reference_dtypes():
    loader = tio.DataLoader(_dataset(tio), batch_size=4,
                            places=[tp.CPUPlace()])
    (inp, label) = next(iter(loader))
    assert inp["x"].device.type == "cpu" and inp["x"].dtype == torch.float32
    assert label.dtype == torch.int32          # int64 -> int32, as JAX's
    assert inp["meta"][1].dtype == torch.float32
    ref = next(iter(rio.DataLoader(_dataset(rio), batch_size=4)))
    assert str(ref[1].dtype) == "int32"


def test_iterable_dataset_path_and_its_traps():
    """The iterable path batches in the parent: ``num_workers`` is not
    read, and neither is ``timeout``; ``get_worker_info()`` is None."""
    parent = os.getpid()

    def make(io):
        class Stream(io.IterableDataset):
            def __iter__(self):
                for i in range(10):
                    yield (np.float32(i), np.int64(os.getpid()),
                           np.int64(io.get_worker_info() is None))
        return Stream()

    got = _epoch(tio.DataLoader(make(tio), batch_size=4, num_workers=3,
                                timeout=1e-9))
    want = _epoch(rio.DataLoader(make(rio), batch_size=4, num_workers=3))
    for g, w in zip(got, want):
        _same(g, w)
    assert [len(b[0]) for b in got] == [4, 4, 2]
    assert {int(p) for b in got for p in b[1]} == {parent}
    with pytest.raises(TypeError):
        len(tio.DataLoader(make(tio), batch_size=4))
    assert len(_epoch(tio.DataLoader(make(tio), batch_size=4,
                                     drop_last=True))) == 2


# ---- the shared-memory worker processes -----------------------------------

_INIT_ID = -1


def _init_worker(worker_id):
    global _INIT_ID
    _INIT_ID = worker_id


class _Probe(tio.Dataset):
    """Each sample: its index's payload, the worker's process id, the
    worker id its init function set, and get_worker_info() is None."""

    def __init__(self, n=40, bad=None):
        self.n, self.bad = n, bad

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"bad sample {i}")
        return (np.full((3,), i, np.float32), np.int64(os.getpid()),
                np.int64(_INIT_ID), np.int64(tio.get_worker_info() is None))

    def __len__(self):
        return self.n


def test_shared_memory_path_order_epochs_and_worker_init():
    ds = _Probe()
    want = _epoch(tio.DataLoader(ds, batch_size=3))
    loader = tio.DataLoader(ds, batch_size=3, num_workers=3,
                            worker_init_fn=_init_worker)
    it = iter(loader)
    assert isinstance(it, shm_channel.MultiprocessDataLoaderIter)
    pids = set(it.pids)
    for epoch in range(3):
        got = [_host(b) for b in it] if epoch == 0 else _epoch(loader)
        assert len(got) == len(want) == 14
        for g, w in zip(got, want):
            _same(g[0], w[0])
            # served by a worker process whose init function ran
            if epoch == 0:
                assert set(g[1].tolist()) <= pids
            assert os.getpid() not in set(g[1].tolist())
            assert set(g[2].tolist()) <= {0, 1, 2}
            assert g[3].tolist() == [1] * len(g[3])      # info is None
    assert _INIT_ID == -1                  # the parent's stays untouched


def test_shared_memory_persistent_workers_are_reused():
    ds = _Probe(n=20)
    want = _epoch(tio.DataLoader(ds, batch_size=4))
    loader = tio.DataLoader(ds, batch_size=4, num_workers=2,
                            persistent_workers=True)
    first = iter(loader)
    pids = first.pids
    for epoch in range(3):
        it = first if epoch == 0 else iter(loader)
        assert it is first and it.pids == pids
        got = [_host(b) for b in it]
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            _same(g[0], w[0])
        assert {int(p) for g in got for p in g[1]} <= set(pids)
    # an aborted epoch: the next one starts over, whole and in order
    it = iter(loader)
    next(it)
    got = _epoch(loader)
    assert len(got) == 5
    for g, w in zip(got, want):
        _same(g[0], w[0])
    assert all(p.is_alive() for p in first._procs)
    first.close()
    assert not any(p.is_alive() for p in first._procs)
    assert loader._persistent_iter is None


def test_shared_memory_worker_exception_reaches_the_parent():
    loader = tio.DataLoader(_Probe(n=30, bad=13), batch_size=4,
                            num_workers=2)
    it = iter(loader)
    with pytest.raises(RuntimeError, match="worker failed.*bad sample 13"):
        list(it)
    assert not any(p.is_alive() for p in it._procs)
    # a persistent loader's failed iterator is dropped and made anew
    loader = tio.DataLoader(_Probe(n=30, bad=13), batch_size=4,
                            num_workers=2, persistent_workers=True)
    with pytest.raises(RuntimeError, match="bad sample 13"):
        list(loader)
    assert loader._persistent_iter is None


def test_tensor_datasets_stay_on_threads():
    """A forked worker must never touch CUDA: a TensorDataset (or a
    wrapper of one), or a dataset whose sample holds a tensor, runs on
    the thread path, which gives the same batches."""
    t = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    y = np.arange(10)

    class Holds(tio.Dataset):
        def __getitem__(self, i):
            return t[i], y[i]

        def __len__(self):
            return 10

    for ds in (tio.TensorDataset([t, y]),
               tio.Subset(tio.TensorDataset([t, y]), range(10)),
               tio.ConcatDataset([tio.TensorDataset([t, y])]), Holds()):
        loader = tio.DataLoader(ds, batch_size=3, num_workers=2)
        it = iter(loader)
        assert isinstance(it, tio._DataLoaderIter)
        got = [_host(b) for b in it]
        want = _epoch(tio.DataLoader(ds, batch_size=3))
        for g, w in zip(got, want):
            _same(g, w)
        assert got[0][0].tolist() == t[:3].tolist()
    with pytest.warns(UserWarning, match="persistent_workers"):
        iter(tio.DataLoader(Holds(), batch_size=3, num_workers=2,
                            persistent_workers=True))


def test_thread_path_raises_a_sample_error():
    loader = tio.DataLoader(_Probe(n=12, bad=5), batch_size=4,
                            num_workers=2, use_shared_memory=False)
    with pytest.raises(ValueError, match="bad sample 5"):
        list(loader)


def test_shm_ring_round_trip_wraparound_and_oversize():
    name = f"/ptt_test_{os.getpid()}"
    ring = shm_channel.ShmRing(name, slot_size=64, n_slots=4, create=True)
    reader = shm_channel.ShmRing(name, create=False)
    assert reader.slot_size == ring.slot_size == 64
    try:
        payloads = [bytes([i]) * (5 * i) for i in range(11)] + [b""]
        tickets, got = [], []
        for i, p in enumerate(payloads):           # 12 records, 4 slots
            tickets.append(ring.write(p))
            if i % 3 == 2:
                got += [reader.read(timeout_us=0) for _ in range(3)]
        assert tickets == list(range(12)) and got == payloads
        with pytest.raises(ValueError, match="exceeds slot_size"):
            ring.write(b"x" * 65)
        assert reader.read(timeout_us=1000) is None    # nothing pending
        ring.write(b"abc")
        ring.write(b"")
        assert reader.read(timeout_us=0) == b"abc"
        assert reader.read(timeout_us=0) == b""        # a record, not None
    finally:
        reader.close()
        ring.close()
    with pytest.raises(OSError, match="open failed"):
        shm_channel.ShmRing(name, create=False)


def test_shm_ring_keeps_ticket_order_across_processes():
    name = f"/ptt_test_mp_{os.getpid()}"
    ring = shm_channel.ShmRing(name, slot_size=32, n_slots=4, create=True)
    child = os.fork()
    if child == 0:                                     # the producer
        try:
            w = shm_channel.ShmRing(name, create=False)
            for i in range(25):
                w.write(pickle.dumps(i))
            w.close()
        finally:
            os._exit(0)
    got = [pickle.loads(ring.read(timeout_us=10_000_000)) for _ in range(25)]
    os.waitpid(child, 0)
    ring.close()
    assert got == list(range(25))


def test_native_batch_assembler_gathers_rows_in_order():
    rng = np.random.default_rng(5)
    arr = rng.standard_normal((50, 4, 3)).astype(np.float32)
    asm = native_loader.NativeBatchAssembler(arr, n_threads=3, queue_cap=4)
    assert asm.native
    batches = [rng.integers(0, 50, k) for k in (7, 1, 12, 7)]
    for b in batches:
        asm.submit(b)
    for b in batches:
        assert asm.next(len(b)).tobytes() == arr[b].tobytes()
    asm.close()
    assert not asm.native


# ---- save / load -----------------------------------------------------------

def _ref_values(obj):
    return {k: np.asarray(v._value) for k, v in obj.items()}


def test_save_load_port_to_reference_bit_exact(tmp_path):
    rng = np.random.default_rng(7)
    net = tp.nn.Linear(5, 3)
    state = dict(net.state_dict())
    state["ids"] = torch.from_numpy(rng.integers(-9, 9, (4,)).astype(
        np.int32))
    state["special"] = torch.tensor([np.inf, -0.0, 1e-40, np.nan])
    path = str(tmp_path / "port.pdparams")
    tp.save({"model": state, "step": 3, "names": ["a", "b"]}, path)
    ref = rp.load(path)
    assert ref["step"] == 3 and ref["names"] == ["a", "b"]
    got = _ref_values(ref["model"])
    for k, v in state.items():
        assert got[k].dtype == v.numpy().dtype
        assert got[k].tobytes() == v.numpy().tobytes(), k
    # the reference's network takes the port's weights
    rnet = rp.nn.Linear(5, 3)
    rnet.set_state_dict(rp.load(path)["model"])
    x = rng.standard_normal((2, 5)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(rnet(rp.to_tensor(x))._value),
                               net(torch.from_numpy(x)).detach().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_save_load_reference_to_port_bit_exact(tmp_path):
    rng = np.random.default_rng(8)
    rp.seed(3)
    rnet = rp.nn.Linear(4, 6)
    obj = {"state": rnet.state_dict(),
           "buf": rp.to_tensor(rng.integers(0, 100, (3,)).astype(np.int32)),
           "list": [rp.to_tensor(np.float32(2.5)), 7]}
    path = str(tmp_path / "ref.pdparams")
    rp.save(obj, path)
    got = tp.load(path)
    for k, v in obj["state"].items():
        t = got["state"][k]
        assert isinstance(t, torch.nn.Parameter) and t.requires_grad
        assert t.numpy(force=True).tobytes() == np.asarray(
            v._value).tobytes()
    assert got["buf"].dtype == torch.int32 and not got["buf"].requires_grad
    assert got["buf"].tolist() == np.asarray(obj["buf"]._value).tolist()
    assert float(got["list"][0]) == 2.5 and got["list"][1] == 7
    arrs = tp.load(path, return_numpy=True)
    assert isinstance(arrs["state"]["weight"], np.ndarray)
    net = tp.nn.Linear(4, 6)
    assert net.set_state_dict(got["state"]) == ([], [])
    assert torch.equal(net.weight, got["state"]["weight"])


def test_save_load_bfloat16_keeps_the_bits(tmp_path):
    import ml_dtypes
    bits = np.random.default_rng(9).integers(0, 2 ** 16, (5, 7),
                                             dtype=np.uint16)
    bits[0, :3] = [0x7F80, 0xFF80, 0x7FC1]          # inf, -inf, a nan
    # the reference's file (an ml_dtypes array) into the port
    ref = rp.to_tensor(bits.view(ml_dtypes.bfloat16))
    rp.save({"w": ref}, str(tmp_path / "ref.pd"))
    got = tp.load(str(tmp_path / "ref.pd"))["w"]
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().view(np.uint16).tobytes() \
        == bits.tobytes()
    # the port's file: uint16 bits with a dtype tag, in this process ...
    t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    tp.save({"w": t, "p": torch.nn.Parameter(t.clone())},
            str(tmp_path / "port.pd"))
    with open(tmp_path / "port.pd", "rb") as f:
        raw = pickle.load(f)
    assert raw["w"]["dtype"] == "bfloat16" and raw["w"]["data"].dtype \
        == np.uint16
    back = tp.load(str(tmp_path / "port.pd"))
    for k in ("w", "p"):
        assert back[k].dtype == torch.bfloat16
        assert torch.equal(back[k].view(torch.int16), t.view(torch.int16))
    assert isinstance(back["p"], torch.nn.Parameter)
    arr = tp.load(str(tmp_path / "port.pd"), return_numpy=True)["w"]
    assert arr.dtype == ml_dtypes.bfloat16 and arr.view(
        np.uint16).tobytes() == bits.tobytes()
    # ... and where ml_dtypes cannot be imported
    code = f"""
import sys
sys.modules["ml_dtypes"] = None
import numpy as np, torch
import paddle_tpu_torch as paddle
paddle.set_device("cpu")
w = paddle.load({str(tmp_path / 'port.pd')!r})["w"]
assert w.dtype == torch.bfloat16
sys.stdout.write(w.view(torch.int16).numpy().tobytes().hex() + "\\n")
a = paddle.load({str(tmp_path / 'port.pd')!r}, return_numpy=True)["w"]
assert a.dtype == np.float32
assert np.array_equal(a, w.float().numpy(), equal_nan=True)
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert bytes.fromhex(proc.stdout.split()[-1]) == bits.tobytes()


def test_save_is_atomic(tmp_path):
    path = str(tmp_path / "ckpt" / "w.pdparams")
    tp.save({"w": torch.ones(3)}, path)
    with pytest.raises(Exception):
        tp.save({"w": torch.zeros(3), "bad": lambda: 0}, path)
    assert torch.equal(tp.load(path)["w"], torch.ones(3))
    assert os.listdir(tmp_path / "ckpt") == ["w.pdparams"]


# ---- device ----------------------------------------------------------------

def test_device_namespace_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    assert tp.device is device
    assert device.get_all_device_type() == ["cpu"]
    assert device.get_available_device() == ["cpu:0"]
    assert device.is_compiled_with_cuda() == (torch.version.cuda
                                              is not None)
    assert tp.is_compiled_with_cuda is device.is_compiled_with_cuda
    assert not device.is_compiled_with_xpu()
    assert not device.is_compiled_with_cinn()
    assert device.cuda_device_count() == 0
    for fn in (device.memory_allocated, device.max_memory_allocated,
               device.memory_reserved, device.max_memory_reserved):
        assert fn("cpu") == 0 and fn() == 0       # default set to the CPU
    assert device.memory_stats("cpu") == {}
    device.reset_peak_memory_stats()
    device.cuda.synchronize()
    device.empty_cache()
    assert device.get_device() == "cpu:0"
    place._default = torch.device("cuda")
    for fn in (device.memory_allocated, device.cuda.synchronize):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.memory_allocated(0)


def test_custom_device_registry(tmp_path):
    custom_device.register_fake_device("fake_npu", "cpu")
    try:
        assert "fake_npu" in device.get_all_custom_device_type()
        assert custom_device.is_custom_device("fake_npu")
        assert custom_device.get_device_count("fake_npu") == 1
        assert custom_device.devices("fake_npu") == [torch.device("cpu")]
        assert device.get_available_custom_device() == ["fake_npu:0"]
    finally:
        custom_device.unregister_custom_device("fake_npu")
    assert not custom_device.is_custom_device("fake_npu")
    with pytest.raises(FileNotFoundError):
        custom_device.register_custom_device(
            "x", str(tmp_path / "missing.so"))
    custom_device.register_custom_device("plain")
    try:
        assert custom_device.get_device_count("plain") == 0
    finally:
        custom_device.unregister_custom_device("plain")


# ---- autotune --------------------------------------------------------------

def test_autotune_cache_key_export_and_load_against_the_reference(tmp_path):
    import jax.numpy as jnp
    a = torch.zeros(4, 8)
    b = torch.zeros(3, dtype=torch.int32)
    ref_key = ref_autotune.AutoTuneCache().key(
        "op", (jnp.zeros((4, 8)), jnp.zeros(3, jnp.int32), 5), "t")
    key = autotune.AutoTuneCache().key("op", (a, b, 5), "t")
    assert key == ref_key
    c = autotune.AutoTuneCache()
    c.put(key, 2, [0.3, 0.2, 0.1])
    c.put(("other", ((2,), "bfloat16"), ""), 0)
    c.export(str(tmp_path / "port.json"))
    r = ref_autotune.AutoTuneCache()
    r.load(str(tmp_path / "port.json"))
    assert r._cache == c._cache
    r.export(str(tmp_path / "ref.json"))
    back = autotune.AutoTuneCache()
    back.load(str(tmp_path / "ref.json"))
    assert back._cache == c._cache
    assert back.get(key) == 2 and back.get(("none", (), "")) is None
    assert back.peek(key) == 2
    assert back.report() == {"hits": 1, "misses": 1, "size": 2}


def test_autotune_picks_the_fastest_and_caches(monkeypatch):
    monkeypatch.setattr(autotune, "_CACHE", autotune.AutoTuneCache())
    calls = []

    def slow(x):
        calls.append("slow")
        time.sleep(0.01)
        return x

    def fast(x):
        calls.append("fast")
        return x

    def broken(x):
        raise RuntimeError("no")

    x = torch.zeros(2)
    assert not autotune.autotune_enabled()
    assert autotune.autotune("op", [slow, fast], (x,)) is slow  # off
    autotune.enable_autotune()
    try:
        assert autotune.autotune_enabled()
        assert autotune.autotune("op", [slow, fast, broken], (x,),
                                 tag="a") is fast
        n = len(calls)
        assert autotune.autotune("op", [slow, fast, broken], (x,),
                                 tag="a") is fast
        assert len(calls) == n                      # a cache hit
        assert autotune.cache().report() == {"hits": 1, "misses": 1,
                                             "size": 1}
        assert autotune.autotune("op", [broken, broken], (x,), default=1,
                                 tag="b") is broken
    finally:
        autotune.disable_autotune()
    assert tp.get_flags("use_autotune") == {"use_autotune": False}
