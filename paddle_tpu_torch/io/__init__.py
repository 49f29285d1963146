"""``paddle.io`` of the PyTorch port: datasets, samplers, ``DataLoader``.

Counterpart of ``paddle_tpu/io/__init__.py``: the datasets (``:25-131``),
the samplers (``:133-269``), ``default_collate_fn`` (``:271-288``), the
loader with its synchronous, thread (``_DataLoaderIter``, ``:290-361``)
and iterable paths, and ``get_worker_info`` (``:363-501``). Samples and
batches are numpy on the host, in the workers too; the parent turns each
batch into ``torch.Tensor``s through the port's ``to_tensor`` on the
loader's device: the default device (``cuda`` unless ``set_device`` said
otherwise), or the first of ``places`` when the caller gives it (the
reference never reads ``places``; the port reads it so that a caller can
ask for the CPU). ``to_tensor``'s dtypes are the reference's: int64
batches become int32 and float64 float32.

``num_workers > 0`` runs worker *processes* over the shared-memory ring of
``csrc/shm_ring.cc`` (``io.shm_channel``), as the reference chooses
(``:409-440``), unless ``use_shared_memory=False`` or the dataset holds
``torch.Tensor``s (a ``TensorDataset`` or a wrapper of one, or a sample
with a tensor in it: ``_holds_device_arrays``), which stay on threads,
because a forked worker must never touch CUDA. The native library is built
at the first such iteration; a failed build raises, and nothing falls back
to threads.

The random draws (``RandomSampler``, ``random_split``,
``WeightedRandomSampler``) come from the port's default generator
(``core.generator``: its CPU ``torch.Generator``, reseeded by
``paddle.seed``), so one seed repeats the same order; they are not the
reference's numbers, which are JAX threefry draws (``:124-125``,
``:163-171``). ``DistributedBatchSampler`` shuffles through numpy, as the
reference, and gives its order exactly.

Kept as the reference has them (ROADMAP Queue 3): ``get_worker_info()``
is None, inside a worker too; the iterable path ignores ``num_workers``;
``timeout`` is not read; an ``IterableDataset``'s ``__len__`` raises
RuntimeError, so ``list(dataset)`` raises (iterate it with ``iter``).
"""
from __future__ import annotations

import itertools
import queue
import threading
import warnings
from typing import List

import numpy as np
import torch

from ..core import generator as _gen
from ..core.place import resolve_device
from ..core.tensor import to_tensor


class Dataset:
    """``paddle.io.Dataset``: a map-style dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not indexable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long tensors or arrays; a ``torch.Tensor`` gives
    its row as a tensor (on its device), an array as numpy."""

    def __init__(self, tensors: List):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] if isinstance(t, torch.Tensor)
                     else np.asarray(t)[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if d == 0 else self.cum[d - 1]
        return self.datasets[d][idx - prev]

    def __len__(self):
        return int(self.cum[-1])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        return itertools.chain(*self.datasets)


class ComposeDataset(Dataset):
    """Map-style datasets of one length, zipped field by field."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets must not be empty")
        n = len(self.datasets[0])
        for d in self.datasets[1:]:
            if len(d) != n:
                raise ValueError("all datasets must have the same length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            if isinstance(item, (tuple, list)):
                out.extend(item)
            else:
                out.append(item)
        return tuple(out)


def _cpu_generator(generator):
    return _gen.torch_generator(generator, "cpu")


def random_split(dataset, lengths, generator=None):
    """Subsets of ``lengths`` over one permutation drawn from
    ``generator`` (the default generator when None)."""
    n = len(dataset)
    if sum(lengths) != n:
        raise ValueError("sum of lengths must equal dataset size")
    perm = torch.randperm(n, generator=_cpu_generator(generator)).tolist()
    out, off = [], 0
    for length in lengths:
        out.append(Subset(dataset, perm[off:off + length]))
        off += length
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    """A permutation (or, with ``replacement``, uniform draws) of the
    indices, from ``generator`` (the default generator when None)."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        g = _cpu_generator(self.generator)
        if self.replacement:
            idx = torch.randint(0, n, (self.num_samples,), generator=g)
        else:
            idx = torch.randperm(n, generator=g)[:self.num_samples]
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """``num_samples`` indices drawn in proportion to ``weights``, from
    the default generator."""

    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        idx = torch.multinomial(torch.from_numpy(self.weights),
                                self.num_samples, self.replacement,
                                generator=_cpu_generator(None))
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """This rank's batches of the index space padded to a multiple of the
    ranks; ``shuffle`` permutes it by numpy from the epoch (``set_epoch``),
    as the reference. ``num_replicas`` / ``rank`` default to the world
    size and rank of ``distributed`` (1 / 0 with no process group)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import get_rank, get_world_size
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None \
            else get_world_size()
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        n = len(dataset)
        self.num_samples = (n + self.nranks - 1) // self.nranks
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = list(range(n))
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            rng.shuffle(indices)
        indices += indices[: self.total_size - n]
        local = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Samples -> one batch, field by field: arrays stacked, Python ints
    int64, floats float32, dicts and sequences by field. ``torch.Tensor``
    samples are stacked and brought to the host as one CPU tensor (numpy
    cannot hold bfloat16)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, torch.Tensor):
        return torch.stack([s.detach() for s in batch]).cpu()
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(col))
                            for col in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


class _DataLoaderIter:
    """Worker threads over one work queue, batches handed out in order
    (the reference's thread path)."""

    def __init__(self, loader, device):
        self.loader = loader
        self.device = device
        self._batches = iter(loader._index_iter())
        self._queue: queue.Queue = queue.Queue(
            maxsize=max(2, loader.prefetch_factor))
        self._threads = []
        self._stop = threading.Event()
        nw = max(1, loader.num_workers)
        self._work_q: queue.Queue = queue.Queue(maxsize=nw * 2)
        self._out = {}
        self._out_lock = threading.Lock()
        self._next_seq = 0
        self._done_workers = 0
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        for _ in range(nw):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)
        self._feeder.start()

    def _feed(self):
        seq = 0
        for b in self._batches:
            if self._stop.is_set():
                return
            self._work_q.put((seq, b))
            seq += 1
        for _ in self._threads:
            self._work_q.put(None)

    def _worker(self):
        while not self._stop.is_set():
            item = self._work_q.get()
            if item is None:
                self._queue.put(None)
                return
            seq, idx_batch = item
            try:
                data = self.loader._fetch(idx_batch)
                self._queue.put((seq, data))
            except Exception as e:  # noqa: BLE001 — raised by __next__
                self._queue.put((seq, e))

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            with self._out_lock:
                if self._next_seq in self._out:
                    data = self._out.pop(self._next_seq)
                    self._next_seq += 1
                    if isinstance(data, Exception):
                        raise data
                    return self.loader._to_tensors(data, self.device)
            if self._done_workers >= len(self._threads) and not self._out:
                raise StopIteration
            item = self._queue.get()
            if item is None:
                self._done_workers += 1
                continue
            seq, data = item
            with self._out_lock:
                self._out[seq] = data

    def __del__(self):
        self._stop.set()


def _has_tensor(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, (list, tuple)):
        return any(_has_tensor(v) for v in obj)
    if isinstance(obj, dict):
        return any(_has_tensor(v) for v in obj.values())
    return False


class DataLoader:
    """``paddle.io.DataLoader`` (module docstring)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.places = places
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.persistent_workers = persistent_workers
        self._persistent_iter = None
        self.prefetch_factor = prefetch_factor
        self.return_list = return_list
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def _device(self) -> torch.device:
        """The first of ``places``, else the default device; raises when
        that is CUDA and there is none."""
        place = self.places
        if isinstance(place, (list, tuple)):
            place = place[0] if place else None
        return resolve_device(place)

    def _index_iter(self):
        return iter(self.batch_sampler)

    def _fetch(self, idx_batch):
        samples = [self.dataset[i] for i in idx_batch]
        return self.collate_fn(samples)

    def _to_tensors(self, data, device):
        if isinstance(data, (np.ndarray, torch.Tensor)):
            return to_tensor(data, place=device)
        if isinstance(data, (list, tuple)):
            return type(data)(self._to_tensors(d, device) for d in data)
        if isinstance(data, dict):
            return {k: self._to_tensors(v, device) for k, v in data.items()}
        return data

    def __iter__(self):
        device = self._device()
        if self._iterable_mode:
            return self._iter_iterable(device)
        if self.num_workers == 0:
            return self._iter_sync(device)
        if self.use_shared_memory and not self._holds_device_arrays():
            # worker processes over the native shared-memory ring
            from ..utils import native
            from .shm_channel import MultiprocessDataLoaderIter
            native.get_lib()                    # a failed build raises
            if not self.persistent_workers:
                return MultiprocessDataLoaderIter(self, device)
            # persistent workers: fork once, reuse processes and ring
            # across epochs; an iterator that shut down (worker error,
            # stall) cleared the cache and is made anew here
            if self._persistent_iter is None:
                self._persistent_iter = MultiprocessDataLoaderIter(
                    self, device, persistent=True)
            else:
                self._persistent_iter.start_epoch(device)
            return self._persistent_iter
        if self.persistent_workers:
            warnings.warn(
                "persistent_workers=True has no effect on the thread path "
                "(use_shared_memory=False, or the dataset holds tensors): "
                "workers are threads made anew each epoch", stacklevel=2)
        return _DataLoaderIter(self, device)

    def _holds_device_arrays(self) -> bool:
        """Whether the dataset holds ``torch.Tensor``s (then it stays on
        threads: a forked worker must never touch CUDA). Found once, from
        the wrappers and one sample, and kept: the probe costs a
        ``__getitem__``."""
        cached = getattr(self, "_fork_safe_cache", None)
        if cached is not None:
            return cached
        result = self._probe_device_arrays()
        self._fork_safe_cache = result
        return result

    def _probe_device_arrays(self) -> bool:
        def ds_has_tensors(ds) -> bool:
            if isinstance(ds, TensorDataset):
                return True
            if isinstance(ds, Subset):
                return ds_has_tensors(ds.dataset)
            if isinstance(ds, (ConcatDataset, ComposeDataset)):
                return any(ds_has_tensors(d) for d in ds.datasets)
            return False

        if ds_has_tensors(self.dataset):
            return True
        try:
            sample = self.dataset[0]
        except Exception:  # noqa: BLE001 — left to the worker to raise
            return False
        return _has_tensor(sample)

    def _iter_sync(self, device):
        for idx_batch in self._index_iter():
            yield self._to_tensors(self._fetch(idx_batch), device)

    def _iter_iterable(self, device):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._to_tensors(self.collate_fn(batch), device)
                batch = []
        if batch and not self.drop_last:
            yield self._to_tensors(self.collate_fn(batch), device)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)


def get_worker_info():
    """None, inside a worker too (the reference's)."""
    return None
