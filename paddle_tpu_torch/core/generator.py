"""Random number generator of the PyTorch port.

Counterpart of ``paddle_tpu/core/generator.py:19-66`` (``Generator``,
``default_generator``, ``seed``). The reference folds (seed, offset) into
a JAX key for each random op; here a ``Generator`` keeps one seeded
``torch.Generator`` per device, and every random op of the port (the
dropout masks, the dropout-add-LayerNorm bits, the layers' initial
weights) draws from the one of its tensor's device. The two packages give
different numbers from one seed: the tests hand both the same inputs.
"""
from __future__ import annotations

import threading
import time

import torch


class Generator:
    """A seed and, lazily, one ``torch.Generator`` per device seeded with
    it."""

    def __init__(self, seed: int | None = None):
        self._lock = threading.Lock()
        if seed is None:
            seed = int(time.time_ns() % (2 ** 63))
        self._seed = int(seed)
        self._per_device: dict = {}

    def manual_seed(self, seed: int) -> "Generator":
        """Reseed: every device's stream starts again from ``seed``."""
        with self._lock:
            self._seed = int(seed)
            self._per_device.clear()
        return self

    def initial_seed(self) -> int:
        return self._seed

    def torch_generator(self, device) -> torch.Generator:
        """The ``torch.Generator`` of ``device``, made and seeded at its
        first use."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            gen = self._per_device.get(dev)
            if gen is None:
                gen = torch.Generator(device=dev).manual_seed(self._seed)
                self._per_device[dev] = gen
            return gen


_default_generator = Generator(seed=0)


def default_generator() -> Generator:
    return _default_generator


def seed(s: int) -> Generator:
    """``paddle.seed``: reseed the default generator."""
    return _default_generator.manual_seed(int(s))


def torch_generator(generator, device) -> torch.Generator:
    """The ``torch.Generator`` a random op on ``device`` draws from:
    ``generator`` itself when it is one, else the per-device one of the
    port's ``Generator`` given (the default generator for None)."""
    if isinstance(generator, torch.Generator):
        return generator
    return (generator or _default_generator).torch_generator(device)
