"""The model-parallel random state of the PyTorch port.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
parallel_layers/random.py``: ``RNGStatesTracker`` keeps named
``core.generator.Generator``s (one seeded ``torch.Generator`` per device
each); ``rng_state(name)`` makes one the default generator within it, so
the dropout of a tensor-parallel layer draws differently on each model
rank while plain dropout draws alike. ``model_parallel_random_seed``
seeds the tracker per model rank and the default generator globally.
"""
from __future__ import annotations

import random as _pyrandom
from contextlib import contextmanager

from .....core import generator as _gen
from .....core.generator import Generator
from .... import topology as _topo

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name: str, seed: int):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        self.states_[name] = Generator(seed)

    def get_states_tracker(self):
        return {n: g.get_state() for n, g in self.states_.items()}

    def set_states_tracker(self, states):
        for n, s in states.items():
            self.states_.setdefault(n, Generator(0)).set_state(s)

    @contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        prev = _gen._default_generator
        _gen._default_generator = self.states_[name]
        try:
            yield
        finally:
            _gen._default_generator = prev


RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    """A seed per model rank for the tracker (``seed * 1024 + rank * 100``)
    and ``seed`` for the default generator, alike on every rank (both
    random without ``seed``)."""
    hcg = _topo.get_hybrid_communicate_group()
    rank = hcg.get_model_parallel_rank() if hcg else 0
    if seed:
        global_seed = seed
        local_seed = seed * 1024 + rank * 100
    else:
        global_seed = _pyrandom.randint(0, 655350)
        local_seed = _pyrandom.randint(rank * 10000, (rank + 1) * 10000 - 1)
    RNG_STATE_TRACKER.reset()
    RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, local_seed)
    _gen.seed(global_seed)
