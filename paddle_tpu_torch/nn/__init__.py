"""nn of the PyTorch port (counterpart of ``paddle_tpu/nn``): ``Layer``
and its containers, every layer and function of the reference's ``nn``
but the transposed convolutions (ROADMAP item 16), the losses, the
initializers and ``ParamAttr``, and the gradient clips the optimizers
take. Every layer is a ``Layer`` (a
``torch.nn.Module`` with Paddle's names, ``layer.layers``) that takes
``device`` (the default device unless ``"cpu"`` or another is asked for;
without a card a default or ``"cuda"`` device raises) where it holds
parameters or buffers and, where it draws random numbers,
``generator``."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .initializer import ParamAttr  # noqa: F401
from .layer import *  # noqa: F401,F403


class ClipGradByGlobalNorm:
    """Scale every gradient by min(1, clip_norm / the global norm of all
    of them) (``paddle_tpu/nn/__init__.py:54``); read by the optimizers'
    ``_apply_grad_clip``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)


class ClipGradByNorm:
    """Scale each gradient by min(1, clip_norm / its own norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)


class ClipGradByValue:
    """Clamp each gradient to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max
