"""``vision.datasets`` of the PyTorch port.

Counterpart of ``paddle_tpu/vision/datasets.py``, in numpy only, every
dataset a ``paddle_tpu_torch.io.Dataset``: ``MNIST`` and ``FashionMNIST``
(IDX files, gzipped or not), ``Cifar10`` / ``Cifar100`` (the pickled
batches of ``cifar-10-batches-py``), ``ImageFolder`` / ``DatasetFolder``
(a directory of class directories), ``Flowers`` and ``VOC2012`` (local
``.npz`` copies). Where no local file is found, each dataset is the
reference's seeded synthetic data, byte for byte (both draw from numpy):
MNIST's digits (``_synthetic_digits``: 60,000 from seed 0 for ``"train"``,
10,000 from seed 1 otherwise), CIFAR's uniform bytes (seeds 0 / 1),
Flowers' (seeds 11 / 12) and VOC's image / mask pairs (seeds 13 / 14).
Files are looked up under ``~/.cache/paddle_tpu/datasets`` and the paths
given; the reference also looks in three system-wide directories, which
the port does not read. Nothing is downloaded: ``download`` and
``backend`` are accepted and ignored, as in the reference.
``ImageFolder`` reads ``.npy`` files with numpy and imports PIL only for
an image file.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io import Dataset

_SEARCH_DIRS = [os.path.expanduser("~/.cache/paddle_tpu/datasets")]


def _find(fname):
    for d in _SEARCH_DIRS:
        p = os.path.join(d, fname)
        if os.path.exists(p):
            return p
    return None


def _read_idx(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)


def _synthetic_digits(n, seed):
    """Deterministic separable 28x28 'digits': class-dependent stripe and
    blob patterns plus noise (the reference's, number for number)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    images = np.zeros((n, 28, 28), dtype=np.float32)
    yy, xx = np.mgrid[0:28, 0:28]
    for c in range(10):
        mask = labels == c
        k = int(mask.sum())
        if k == 0:
            continue
        base = (np.sin(xx * (c + 1) * 0.35) + np.cos(yy * (c + 2) * 0.3))
        cx, cy = 6 + (c % 5) * 4, 6 + (c // 5) * 12
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 18.0))
        pattern = (0.5 * base + 2.0 * blob).astype(np.float32)
        images[mask] = pattern[None] + rng.normal(
            0, 0.3, size=(k, 28, 28)).astype(np.float32)
    images = (images - images.min()) / (images.max() - images.min() + 1e-6)
    return (images * 255).astype(np.uint8), labels.astype(np.int64)


class MNIST(Dataset):
    """(image (1, 28, 28) float32 scaled by 1 / 255, the transform applied
    if any; label int64)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="cv2"):
        self.mode = mode
        self.transform = transform
        prefix = "train" if mode == "train" else "t10k"
        img = image_path or _find(f"{prefix}-images-idx3-ubyte.gz") \
            or _find(f"{prefix}-images-idx3-ubyte")
        lab = label_path or _find(f"{prefix}-labels-idx1-ubyte.gz") \
            or _find(f"{prefix}-labels-idx1-ubyte")
        if img and lab:
            self.images = _read_idx(img)
            self.labels = _read_idx(lab).astype(np.int64)
        else:
            n = 60000 if mode == "train" else 10000
            self.images, self.labels = _synthetic_digits(
                n, seed=0 if mode == "train" else 1)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None] / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], dtype=np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    """(image (3, 32, 32) float32 scaled by 1 / 255; label int64)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2"):
        self.transform = transform
        import pickle
        found = data_file or _find("cifar-10-batches-py")
        if found and os.path.isdir(found):
            xs, ys = [], []
            names = [f"data_batch_{i}" for i in range(1, 6)] \
                if mode == "train" else ["test_batch"]
            for nme in names:
                with open(os.path.join(found, nme), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                xs.append(d[b"data"])
                ys.extend(d[b"labels"])
            self.images = np.concatenate(xs).reshape(-1, 3, 32, 32)
            self.labels = np.asarray(ys, dtype=np.int64)
        else:
            rng = np.random.default_rng(0 if mode == "train" else 1)
            n = 50000 if mode == "train" else 10000
            self.labels = rng.integers(0, 10, n).astype(np.int64)
            self.images = rng.integers(
                0, 255, (n, 3, 32, 32)).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], dtype=np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    pass


class ImageFolder(Dataset):
    """Files of ``root/<class>/`` (``.npy``, ``.png``, ``.jpg``,
    ``.jpeg``), classes in sorted order: (image float32, class index
    int64). An image file is read with PIL, scaled by 1 / 255 and made
    channels-first."""

    def __init__(self, root, transform=None, loader=None):
        self.root = root
        self.transform = transform
        self.samples = []
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith((".npy", ".png", ".jpg", ".jpeg")):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        if path.endswith(".npy"):
            img = np.load(path).astype(np.float32)
        else:
            from PIL import Image
            img = np.asarray(Image.open(path), dtype=np.float32) / 255.0
            if img.ndim == 3:
                img = img.transpose(2, 0, 1)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(label, dtype=np.int64)

    def __len__(self):
        return len(self.samples)


class DatasetFolder(ImageFolder):
    """The class-directory layout of ``ImageFolder``."""


class Flowers(Dataset):
    """102 flower classes: a local ``flowers.npz`` (``x_<mode>``,
    ``y_<mode>``) or the synthetic fallback."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        self.transform = transform
        local = data_file or os.path.expanduser(
            "~/.cache/paddle_tpu/datasets/flowers.npz")
        if os.path.exists(local):
            d = np.load(local)
            self.x = d[f"x_{mode}"]
            self.y = d[f"y_{mode}"]
        else:
            rng = np.random.default_rng(11 if mode == "train" else 12)
            n = 1020 if mode == "train" else 102
            self.x = rng.random((n, 3, 32, 32), np.float32)
            self.y = np.tile(np.arange(102), n // 102 + 1)[:n].astype(
                np.int64)

    def __getitem__(self, i):
        img = self.x[i]
        if self.transform:
            img = self.transform(img)
        return img, self.y[i]

    def __len__(self):
        return len(self.x)


class VOC2012(Dataset):
    """Segmentation pairs: a local ``voc2012.npz`` or synthetic image /
    21-class mask pairs."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        local = data_file or os.path.expanduser(
            "~/.cache/paddle_tpu/datasets/voc2012.npz")
        if os.path.exists(local):
            d = np.load(local)
            self.x = d[f"x_{mode}"]
            self.y = d[f"y_{mode}"]
        else:
            rng = np.random.default_rng(13 if mode == "train" else 14)
            n = 128 if mode == "train" else 32
            self.x = rng.random((n, 3, 64, 64), np.float32)
            self.y = rng.integers(0, 21, (n, 64, 64)).astype(np.int64)

    def __getitem__(self, i):
        img = self.x[i]
        if self.transform:
            img = self.transform(img)
        return img, self.y[i]

    def __len__(self):
        return len(self.x)
