"""Inference helpers of the PyTorch port.

Counterpart of ``paddle_tpu/inference/__init__.py``. Only
``BatchingConfig`` is ported so far: the admission knobs that
``serving.ServingEngine`` takes. ``DynamicBatcher`` and the predictor
(``Config`` / ``Predictor``) are not ported yet (ROADMAP item 14).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class BatchingConfig:
    """The request-coalescing knobs shared by both batchers: how many
    requests one flush may gather (``max_batch``) and how long the
    oldest waiting request may sit before a partial batch flushes
    anyway (``max_delay_ms``).

    The continuous-batching ``paddle_tpu_torch.serving.ServingEngine``
    (token streams) takes this as its admission config, as the
    reference's ``DynamicBatcher`` (request/response predictors) does.
    """

    max_batch: int = 32
    max_delay_ms: float = 2.0

    @property
    def max_delay(self) -> float:
        """max_delay_ms in seconds (the unit the wait loops use)."""
        return self.max_delay_ms / 1e3
