"""``affine_grid``, ``grid_sample`` and ``temporal_shift`` of the PyTorch
port.

Counterpart of ``paddle_tpu/nn/functional/vision.py:17-142``, the
reference's formulas rather than torch's ``affine_grid`` /
``grid_sample``: ``align_corners`` defaults to True; without it the grid
runs over the pixel centres (-1 + 1/size to 1 - 1/size); the grid is
computed in float32 and cast to theta's dtype. ``grid_sample`` takes
NCHW input and an (N, Ho, Wo, 2) grid of (x, y): "bilinear" or "nearest"
(round half to even, as ``jnp.round``); ``padding_mode`` "zeros" (a
corner outside the input reads 0), "border" (coordinates clamped) or
"reflection" (``_reflect`` over [0, size - 1] with ``align_corners``,
else over [-0.5, size - 0.5] and clamped). Each goes through the op
dispatch under the reference's name.
"""
from __future__ import annotations

import torch

from ...ops.dispatch import apply_op


def _affine_grid(theta, out_shape, align_corners):
    n, c, h, w = (int(s) for s in out_shape)

    def coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, device=theta.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                              device=theta.device)

    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)   # (H, W, 3)
    return torch.einsum("hwk,njk->nhwj", base,
                        theta.to(torch.float32)).to(theta.dtype)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """(N, H, W, 2) sampling grid of the affine maps ``theta`` (N, 2, 3)
    for an output of ``out_shape`` (N, C, H, W)."""
    if hasattr(out_shape, "tolist"):
        out_shape = out_shape.tolist()
    return apply_op("affine_grid", _affine_grid, theta, out_shape=out_shape,
                    align_corners=align_corners)


def _reflect(x, lo, hi):
    rng = hi - lo
    if rng <= 0:
        return torch.zeros_like(x)
    dbl = 2 * rng
    x = torch.remainder(torch.abs(x - lo), dbl)
    return lo + torch.where(x > rng, dbl - x, x)


def _grid_sample(x, grid, mode, padding_mode, align_corners):
    N, C, H, W = x.shape
    gx = grid[..., 0].to(torch.float32)
    gy = grid[..., 1].to(torch.float32)

    def unnorm(g, size):
        if align_corners:
            return (g + 1.0) / 2.0 * (size - 1)
        return ((g + 1.0) * size - 1.0) / 2.0

    fx, fy = unnorm(gx, W), unnorm(gy, H)
    if padding_mode == "border":
        fx, fy = torch.clamp(fx, 0, W - 1), torch.clamp(fy, 0, H - 1)
    elif padding_mode == "reflection":
        if align_corners:
            fx, fy = _reflect(fx, 0.0, W - 1.0), _reflect(fy, 0.0, H - 1.0)
        else:
            fx = torch.clamp(_reflect(fx, -0.5, W - 0.5), 0, W - 1)
            fy = torch.clamp(_reflect(fy, -0.5, H - 0.5), 0, H - 1)
    batch = torch.arange(N, device=x.device)[:, None, None]

    def gather(iy, ix):
        out = x[batch, :, iy.clamp(0, H - 1), ix.clamp(0, W - 1)]
        out = torch.movedim(out, -1, 1)                # (N, C, Ho, Wo)
        if padding_mode == "zeros":
            valid = ((iy >= 0) & (iy <= H - 1) & (ix >= 0) & (ix <= W - 1))
            out = out * valid.to(x.dtype)[:, None]
        return out

    if mode == "nearest":
        return gather(torch.round(fy).long(), torch.round(fx).long())
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    x1, y1 = x0 + 1, y0 + 1
    wx = (fx - x0.to(torch.float32)).to(x.dtype)[:, None]
    wy = (fy - y0.to(torch.float32)).to(x.dtype)[:, None]
    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample NCHW ``x`` at the (x, y) points of ``grid`` (N, Ho, Wo, 2)
    in [-1, 1]."""
    return apply_op("grid_sample", _grid_sample, x, grid, mode=mode,
                    padding_mode=padding_mode, align_corners=align_corners)


def _temporal_shift(x, seg_num, shift_ratio, data_format):
    if data_format == "NHWC":
        x = torch.movedim(x, -1, 1)
    nt, c, h, w = x.shape
    r = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([r[:, 1:, :c1], torch.zeros_like(r[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(r[:, :1, c1:c2]), r[:, :-1, c1:c2]], 1)
    out = torch.cat([back, fwd, r[:, :, c2:]], 2).reshape(nt, c, h, w)
    return torch.movedim(out, 1, -1) if data_format == "NHWC" else out


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """TSM's shift: of each clip's ``seg_num`` frames, the first
    ``shift_ratio`` of the channels move one frame back, the next as many
    one frame forward (zeros enter), the rest stay."""
    return apply_op("temporal_shift", _temporal_shift, x, seg_num=seg_num,
                    shift_ratio=shift_ratio, data_format=data_format)
