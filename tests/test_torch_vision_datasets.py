"""``vision.datasets`` of the PyTorch port against the JAX package's: the
seeded synthetic fallbacks byte for byte (FashionMNIST, Cifar10 /
Cifar100, Flowers and VOC2012, both modes where they are small), their
samples, the IDX / pickled-batch / ``.npz`` readers on local files, and
``ImageFolder`` / ``DatasetFolder`` over a tree of ``.npy`` files (no PIL
needed). Every dataset is a ``paddle_tpu_torch.io.Dataset``."""
import os
import pickle

import numpy as np
import pytest

from paddle_tpu.vision import datasets as ref_ds
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.vision import datasets as port_ds


@pytest.fixture(autouse=True)
def no_local_copies(monkeypatch, tmp_path):
    """Both packages look under ``~/.cache/paddle_tpu/datasets`` (and the
    reference in system-wide directories): point both at an empty
    directory, so the synthetic fallbacks are what is compared."""
    empty = str(tmp_path / "empty")
    monkeypatch.setattr(port_ds, "_SEARCH_DIRS", [empty])
    monkeypatch.setattr(ref_ds, "_SEARCH_DIRS", [empty])
    monkeypatch.setenv("HOME", str(tmp_path / "home"))


def _arrays(ds):
    return {k: v for k, v in vars(ds).items() if isinstance(v, np.ndarray)}


def _same_dataset(got, want, idx=(0, 1, -1)):
    a, b = _arrays(got), _arrays(want)
    assert a.keys() == b.keys() and a
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    assert len(got) == len(want)
    for i in idx:
        for x, y in zip(got[i], want[i]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name,kw", [
    ("FashionMNIST", dict(mode="test")),
    ("Cifar10", dict(mode="test")),
    ("Cifar100", dict(mode="test")),
    ("Flowers", dict(mode="train")),
    ("Flowers", dict(mode="test")),
    ("VOC2012", dict(mode="train")),
    ("VOC2012", dict(mode="test")),
])
def test_synthetic_fallbacks_equal_the_reference(name, kw):
    got = getattr(port_ds, name)(**kw)
    assert isinstance(got, tio.Dataset)
    _same_dataset(got, getattr(ref_ds, name)(**kw))


def test_transform_and_mnist_base():
    assert isinstance(port_ds.MNIST(mode="test"), tio.Dataset)
    got = port_ds.Flowers(mode="test", transform=lambda x: x * 2)
    want = ref_ds.Flowers(mode="test", transform=lambda x: x * 2)
    assert got[5][0].tobytes() == want[5][0].tobytes()


def test_local_files_are_read_as_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    cifar = tmp_path / "cifar-10-batches-py"
    cifar.mkdir()
    for name in ["test_batch"] + [f"data_batch_{i}" for i in range(1, 6)]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 4).tolist()}, f)
    for mode in ("train", "test"):
        _same_dataset(port_ds.Cifar10(str(cifar), mode=mode),
                      ref_ds.Cifar10(str(cifar), mode=mode))
    npz = tmp_path / "flowers.npz"
    np.savez(npz, x_train=rng.random((6, 3, 8, 8), np.float32),
             y_train=np.arange(6), x_test=rng.random((2, 3, 8, 8)),
             y_test=np.arange(2))
    for mode in ("train", "test"):
        _same_dataset(port_ds.Flowers(str(npz), mode=mode),
                      ref_ds.Flowers(str(npz), mode=mode))
        _same_dataset(port_ds.VOC2012(str(npz), mode=mode),
                      ref_ds.VOC2012(str(npz), mode=mode))


@pytest.mark.parametrize("cls", ["ImageFolder", "DatasetFolder"])
def test_image_folder_over_npy_files(cls, tmp_path):
    rng = np.random.default_rng(1)
    for c, n in (("dog", 3), ("cat", 2), ("ant", 2)):
        os.makedirs(tmp_path / c)
        for j in range(n):
            np.save(tmp_path / c / f"{j}.npy",
                    rng.random((3, 4, 4)).astype(np.float64))
    (tmp_path / "cat" / "notes.txt").write_text("skipped")
    got = getattr(port_ds, cls)(str(tmp_path))
    want = getattr(ref_ds, cls)(str(tmp_path))
    assert got.class_to_idx == want.class_to_idx == {"ant": 0, "cat": 1,
                                                     "dog": 2}
    assert got.samples == want.samples and len(got) == 7
    for i in range(len(got)):
        for x, y in zip(got[i], want[i]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert got[0][0].dtype == np.float32
