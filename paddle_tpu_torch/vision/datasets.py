"""``MNIST`` of the PyTorch port.

Counterpart of ``paddle_tpu/vision/datasets.py:1-95`` (``_read_idx``,
``_synthetic_digits``, ``MNIST``), in numpy only. The images and labels are
read from IDX files (gzipped or not) given as ``image_path`` /
``label_path`` or found under ``~/.cache/paddle_tpu/datasets``; without
them the dataset is the reference's deterministic synthetic digits (a
copy of ``_synthetic_digits``: 60,000 from seed 0 for ``"train"``, 10,000
from seed 1 otherwise). Nothing is downloaded: ``download`` and
``backend`` are accepted and ignored, as in the reference (which always
returns arrays). The reference also looks in three
system-wide directories; the port reads nothing outside the caller's home
and the paths it is given. ``__getitem__`` returns ((1, 28, 28) float32
scaled by 1 / 255, the transform applied if any; an int64 label), as the
reference's.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np
from torch.utils.data import Dataset

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
