"""``paddle.metric`` of the PyTorch port.

Counterpart of ``paddle_tpu/metric/__init__.py``: ``Metric``, ``Accuracy``
(top-k), ``Precision``, ``Recall``, ``Auc`` (threshold buckets) and the
function ``accuracy``. ``Accuracy.compute`` and ``accuracy`` run on the
tensors' device (the card in a ``Model.fit`` there); every ``update`` and
``accumulate`` runs on the host in numpy, as the reference's, whose metric
state is tiny. Inputs are tensors (any device, bfloat16 read as float32)
or arrays. The numbers equal the reference's on the same inputs; the
top-k order breaks ties by the lower index (a stable sort) where the
reference's numpy quicksort leaves them in no stated order.

``Auc`` takes ``curve`` and, as the reference, computes the ROC area
whatever it says.
"""
from __future__ import annotations

import abc

import numpy as np
import torch


def _np(x):
    """A tensor (any device; bfloat16 as float32) or array -> numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


def _tensor(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _topk_hits(pred: torch.Tensor, label: torch.Tensor, k: int):
    """(N, k) float32: whether each of the top-k classes of ``pred`` is
    the sample's label (the reference's argsort of -pred)."""
    idx = torch.argsort(-pred, dim=-1, stable=True)[:, :k]
    return idx == label.to(idx.dtype)


class Metric(abc.ABC):
    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def name(self):
        ...

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label):
        """(N, maxk) float32 on ``pred``'s device: whether the i-th best
        class is the label (a one-hot / soft label is taken by its
        argmax)."""
        pred = _tensor(pred)
        label = _tensor(label, pred.device)
        if label.ndim == pred.ndim and label.shape[-1] > 1:
            label = label.argmax(-1)
        label = label.reshape(label.shape[0], -1)
        return _topk_hits(pred, label[:, :1], self.maxk).to(torch.float32)

    def update(self, correct):
        correct = _np(correct)
        accs = []
        for k in self.topk:
            num = correct[:, :k].sum()
            self.total[self.topk.index(k)] += num
            self.count[self.topk.index(k)] += correct.shape[0]
            accs.append(num / correct.shape[0])
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    """Binary precision of rounded predictions."""

    def __init__(self, name=None):
        super().__init__()
        self._name = name or "precision"
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(np.int64).reshape(-1)
        labels = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of rounded predictions."""

    def __init__(self, name=None):
        super().__init__()
        self._name = name or "recall"
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(np.int64).reshape(-1)
        labels = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over ``num_thresholds`` + 1 buckets of the positive-class
    score."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__()
        self.curve = curve
        self.num_thresholds = num_thresholds
        self._name = name or "auc"
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos = preds[:, 1]
        else:
            pos = preds.reshape(-1)
        idx = np.clip((pos * self.num_thresholds).astype(np.int64),
                      0, self.num_thresholds)
        hit = labels.astype(bool)
        np.add.at(self._stat_pos, idx[hit], 1)
        np.add.at(self._stat_neg, idx[~hit], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, dtype=np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            p, n = self._stat_pos[i], self._stat_neg[i]
            auc += n * tot_pos + p * n / 2.0
            tot_pos += p
            tot_neg += n
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """Top-k accuracy of ``input`` against ``label``: a float32 scalar
    tensor on ``input``'s device (the mean taken in float64, as numpy's)."""
    pred = _tensor(input)
    lab = _tensor(label, pred.device).reshape(-1, 1)
    hit = _topk_hits(pred, lab, k).any(dim=1)
    return hit.to(torch.float64).mean().to(torch.float32)
