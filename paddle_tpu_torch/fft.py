"""FFT ops of the PyTorch port (``paddle.fft``).

Counterpart of ``paddle_tpu/fft.py``: the reference's 22 ops over
``torch.fft`` (cuFFT on the card), each an op of the dispatch under the
reference's name, with its arguments (``axis`` / ``axes``, ``n`` / ``s``,
``norm`` "backward" unless "ortho" or "forward" is given). ``hfft2``,
``ihfft2``, ``hfftn`` and ``ihfftn`` are the reference's compositions: a
complex transform over the leading axes and a Hermitian one over the
last. ``fftfreq`` / ``rfftfreq`` are float32 on the default device.
"""
from __future__ import annotations

import torch

from .core.dtype import get_default_dtype
from .core.place import resolve_device
from .ops._util import op

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn", "rfft",
           "irfft", "rfft2", "irfft2", "hfft", "ihfft", "fftshift",
           "ifftshift", "fftfreq", "rfftfreq", "rfftn", "irfftn", "hfft2",
           "ihfft2", "hfftn", "ihfftn"]


def _norm(norm):
    return norm if norm in ("backward", "ortho", "forward") else "backward"


def _resolved(t):
    """``t`` without a lazy conjugate bit (``ihfft`` returns one), so it
    is an ordinary complex tensor."""
    return t.resolve_conj() if t.is_complex() else t


def _one(name, tfn):
    @op(name)
    def fn(x, n=None, axis=-1, norm="backward"):
        return _resolved(tfn(x, n=n, dim=axis, norm=_norm(norm)))
    return fn


def _many(name, tfn, default_axes):
    @op(name)
    def fn(x, s=None, axes=default_axes, norm="backward"):
        return _resolved(tfn(x, s=s, dim=None if axes is None
                             else tuple(axes), norm=_norm(norm)))
    return fn


fft = _one("fft", torch.fft.fft)
ifft = _one("ifft", torch.fft.ifft)
rfft = _one("rfft", torch.fft.rfft)
irfft = _one("irfft", torch.fft.irfft)
hfft = _one("hfft", torch.fft.hfft)
ihfft = _one("ihfft", torch.fft.ihfft)
fft2 = _many("fft2", torch.fft.fftn, (-2, -1))
ifft2 = _many("ifft2", torch.fft.ifftn, (-2, -1))
rfft2 = _many("rfft2", torch.fft.rfftn, (-2, -1))
irfft2 = _many("irfft2", torch.fft.irfftn, (-2, -1))
fftn = _many("fftn", torch.fft.fftn, None)
ifftn = _many("ifftn", torch.fft.ifftn, None)
rfftn = _many("rfftn", torch.fft.rfftn, None)
irfftn = _many("irfftn", torch.fft.irfftn, None)


@op("fftshift")
def fftshift(x, axes=None):
    return torch.fft.fftshift(x, dim=axes)


@op("ifftshift")
def ifftshift(x, axes=None):
    return torch.fft.ifftshift(x, dim=axes)


@op("fftfreq", nondiff=True)
def fftfreq(n, d=1.0):
    return torch.fft.fftfreq(int(n), d, dtype=get_default_dtype(),
                             device=resolve_device(None))


@op("rfftfreq", nondiff=True)
def rfftfreq(n, d=1.0):
    return torch.fft.rfftfreq(int(n), d, dtype=get_default_dtype(),
                              device=resolve_device(None))


def _hermitian(x, s, axes, norm, inverse):
    """The reference's hfft2 / hfftn (and their inverses): ``fftn`` over
    all but the last of ``axes`` and ``hfft`` over the last (the inverse:
    ``ihfft`` first, then ``ifftn``)."""
    ax = tuple(range(-x.dim(), 0)) if axes is None else tuple(axes)
    lead = None if s is None else s[:-1]
    last = None if s is None else s[-1]
    if inverse:
        out = torch.fft.ihfft(x, n=last, dim=ax[-1], norm=_norm(norm))
        return _resolved(torch.fft.ifftn(out, s=lead, dim=ax[:-1],
                                         norm=_norm(norm)))
    out = torch.fft.fftn(x, s=lead, dim=ax[:-1], norm=_norm(norm))
    return torch.fft.hfft(out, n=last, dim=ax[-1], norm=_norm(norm))


@op("hfft2")
def hfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return _hermitian(x, s, axes, norm, inverse=False)


@op("ihfft2")
def ihfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return _hermitian(x, s, axes, norm, inverse=True)


@op("hfftn")
def hfftn(x, s=None, axes=None, norm="backward"):
    return _hermitian(x, s, axes, norm, inverse=False)


@op("ihfftn")
def ihfftn(x, s=None, axes=None, norm="backward"):
    return _hermitian(x, s, axes, norm, inverse=True)
