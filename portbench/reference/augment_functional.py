"""Augmentation ops on host (B, T, H, W, C) chips (port of
cultionet_tpu/augment/functional.py).

x is (B, T, H, W, C); y and bdist are (B, H, W). Every random op is split
in two: a ``draw_*`` function that takes its random values from an explicit
``torch.Generator``, and a pure function of those values (the speeds of
``time_warp``, the steps of ``time_drift``'s walk, a noise tensor,
``crop_resize``'s origin, ``perlin_noise_3d``'s angle lattices). A test can
then hand the JAX package's draws to the pure functions.

90-degree rotations and flips are exact pixel permutations of x, y and
bdist. ``crop_resize`` resizes x and bdist bilinearly and y by nearest
neighbour, with the samples at half-pixel centres as ``jax.image.resize``
places them.
"""

import math
import typing as T

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# x: (B, T, H, W, C); y/bdist: (B, H, W)
_H_AXIS_X, _W_AXIS_X = 2, 3
_H_AXIS_Y, _W_AXIS_Y = 1, 2


def rotate(x: Tensor, y: Tensor, bdist: Tensor, k: int):
    """Rotate by k*90 degrees counterclockwise."""
    return (
        torch.rot90(x, k, dims=(_H_AXIS_X, _W_AXIS_X)),
        torch.rot90(y, k, dims=(_H_AXIS_Y, _W_AXIS_Y)),
        torch.rot90(bdist, k, dims=(_H_AXIS_Y, _W_AXIS_Y)),
    )


def fliplr(x: Tensor, y: Tensor, bdist: Tensor):
    return (
        torch.flip(x, dims=(_W_AXIS_X,)),
        torch.flip(y, dims=(_W_AXIS_Y,)),
        torch.flip(bdist, dims=(_W_AXIS_Y,)),
    )


def flipud(x: Tensor, y: Tensor, bdist: Tensor):
    return (
        torch.flip(x, dims=(_H_AXIS_X,)),
        torch.flip(y, dims=(_H_AXIS_Y,)),
        torch.flip(bdist, dims=(_H_AXIS_Y,)),
    )


def gaussian_blur(x: Tensor, sigma: Tensor) -> Tensor:
    """3x3 gaussian blur over (H, W) with edge padding, as two 1-D passes
    (torchvision's GaussianBlur with kernel 3)."""
    offsets = torch.tensor([-1.0, 0.0, 1.0])
    kernel1d = torch.exp(-(offsets**2) / (2.0 * sigma**2))
    kernel1d = kernel1d / torch.sum(kernel1d)

    def conv_axis(z: Tensor, axis: int) -> Tensor:
        n = z.shape[axis]
        padded = torch.cat(
            [z.narrow(axis, 0, 1), z, z.narrow(axis, n - 1, 1)], dim=axis
        )
        return (
            kernel1d[0] * padded.narrow(axis, 0, n)
            + kernel1d[1] * padded.narrow(axis, 1, n)
            + kernel1d[2] * padded.narrow(axis, 2, n)
        )

    return conv_axis(conv_axis(x, _H_AXIS_X), _W_AXIS_X)


def draw_noise(x: Tensor, generator: torch.Generator) -> Tensor:
    """Standard normal noise of x's shape and dtype."""
    return torch.randn(x.shape, generator=generator, dtype=x.dtype)


def gaussian_noise(x: Tensor, noise: Tensor, sigma: float = 0.01) -> Tensor:
    """The reference's 'salt & pepper': additive gaussian noise."""
    return x + sigma * noise


def roll_time(x: Tensor, shift: int) -> Tensor:
    """Circular shift along the time axis (whole chip); the caller masks
    it to a parcel."""
    return torch.roll(x, shift, dims=1)


def _linspace(start: float, stop: float, num: int) -> Tensor:
    """float32 ``jnp.linspace``: start * (1 - s) + stop * s with s = i /
    (num - 1), and the endpoint exact."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / float(div)
    start_t = torch.tensor(start, dtype=torch.float32)
    stop_t = torch.tensor(stop, dtype=torch.float32)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t[None]])


# jnp.interp's threshold for a zero-width interval: np.spacing of the
# float32 machine epsilon.
_DX_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp``: piecewise-linear through (xp, fp), constant beyond
    the first and last anchors."""
    i = torch.clamp(
        torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1
    )
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= _DX_EPS
    f = torch.where(
        dx0,
        fp[i - 1],
        fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df,
    )
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _interp_time(x: Tensor, src_positions: Tensor) -> Tensor:
    """Linearly resample (B, T, H, W, C) at fractional time positions
    (T',) -> (B, T', H, W, C)."""
    num_time = x.shape[1]
    pos = torch.clamp(src_positions, 0.0, num_time - 1.0)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, num_time - 2)
    frac = (pos - lo).reshape((1, -1) + (1,) * (x.ndim - 2))
    x_lo = torch.index_select(x, 1, lo)
    x_hi = torch.index_select(x, 1, lo + 1)
    return x_lo * (1.0 - frac) + x_hi * frac


def draw_time_warp_speeds(
    generator: torch.Generator,
    n_speed_change: int = 3,
    max_speed_ratio: float = 1.5,
) -> Tensor:
    """n_speed_change + 1 segment speeds, log-uniform within the ratio."""
    log_ratio = math.log(max_speed_ratio)
    u = torch.rand(n_speed_change + 1, generator=generator)
    return torch.exp(u * (2.0 * log_ratio) - log_ratio)


def time_warp(x: Tensor, speeds: Tensor) -> Tensor:
    """Smooth monotone time warp (tsaug.TimeWarp): piecewise-constant
    ``speeds`` over len(speeds) segments, the warped time normalized to
    [0, T-1]."""
    num_time = x.shape[1]
    n_segments = speeds.shape[0]
    seg_len = (num_time - 1) / n_segments
    cum = torch.cat([torch.zeros(1), torch.cumsum(speeds * seg_len, 0)])
    anchors_dst = _linspace(0.0, num_time - 1.0, n_segments + 1)
    cum = cum / cum[-1] * (num_time - 1.0)
    dst = _linspace(0.0, num_time - 1.0, num_time)
    return _interp_time(x, _interp(dst, anchors_dst, cum))


def draw_drift_steps(
    generator: torch.Generator, n_drift_points: int = 3
) -> Tensor:
    """The n_drift_points + 1 standard normal steps of the drift's walk."""
    return torch.randn(n_drift_points + 1, generator=generator)


def time_drift(x: Tensor, steps: Tensor, max_drift: float = 0.1) -> Tensor:
    """Additive smooth drift over time (tsaug.Drift): the walk of ``steps``
    from 0, scaled to at most ``max_drift``, interpolated over T."""
    num_time = x.shape[1]
    walk = torch.cumsum(steps, 0)
    walk = walk - walk[0]
    denom = torch.clamp(torch.max(torch.abs(walk)), min=1e-6)
    walk = walk / denom * max_drift
    anchor_pos = _linspace(0.0, num_time - 1.0, steps.shape[0])
    drift = _interp(_linspace(0.0, num_time - 1.0, num_time), anchor_pos, walk)
    return x + drift.reshape((1, -1) + (1,) * (x.ndim - 2)).to(x.dtype)


def time_peaks(x: Tensor, speeds: Tensor) -> Tensor:
    """tspeaks: two half-rate copies of the series back to back, then
    ``time_warp`` by ``speeds`` (four segments in the augmenter)."""
    num_time = x.shape[1]
    half_a = num_time // 2
    half_b = num_time - half_a
    squeezed = torch.cat(
        [
            _interp_time(x, _linspace(0.0, num_time - 1.0, half_a)),
            _interp_time(x, _linspace(0.0, num_time - 1.0, half_b)),
        ],
        dim=1,
    )
    return time_warp(squeezed, speeds)


def add_time_noise(x: Tensor, noise: Tensor, scale: float = 0.03) -> Tensor:
    """tsaug.AddNoise: i.i.d. gaussian over every element."""
    return x + scale * noise


def draw_crop_origin(
    generator: torch.Generator, height: int, width: int, div: int
) -> T.Tuple[int, int]:
    """The top-left corner of a (H // div, W // div) crop, uniform."""
    row0 = torch.randint(0, height - height // div + 1, (), generator=generator)
    col0 = torch.randint(0, width - width // div + 1, (), generator=generator)
    return int(row0), int(col0)


def _nearest_index(in_size: int, out_size: int) -> Tensor:
    """``jax.image.resize``'s nearest source index, float32 half-pixel
    centres: floor((i + 0.5) * in / out)."""
    centres = torch.arange(out_size, dtype=torch.float32) + 0.5
    return torch.floor(centres * in_size / out_size).to(torch.int64)


def _bilinear(z: Tensor, height: int, width: int) -> Tensor:
    """Bilinear resize of the last two axes with half-pixel centres; at the
    border the nearest edge pixel, as ``jax.image.resize`` renormalizes its
    triangle kernel there."""
    lead = z.shape[:-2]
    flat = z.reshape((-1, 1) + tuple(z.shape[-2:]))
    out = F.interpolate(
        flat, size=(height, width), mode="bilinear", align_corners=False
    )
    return out.reshape(lead + (height, width))


def crop_resize(
    x: Tensor,
    y: Tensor,
    bdist: Tensor,
    row0: int,
    col0: int,
    div: int,
):
    """Crop (H // div, W // div) at (row0, col0) and resize back: bilinear
    for x and bdist, nearest for y."""
    _, _, height, width, _ = x.shape
    crop_h, crop_w = height // div, width // div
    rows = slice(row0, row0 + crop_h)
    cols = slice(col0, col0 + crop_w)
    x_crop = x[:, :, rows, cols, :].permute(0, 1, 4, 2, 3)
    x_out = _bilinear(x_crop, height, width).permute(0, 1, 3, 4, 2)
    b_out = _bilinear(bdist[:, rows, cols], height, width)
    y_crop = y[:, rows, cols]
    y_out = y_crop[:, _nearest_index(crop_h, height)][
        :, :, _nearest_index(crop_w, width)
    ]
    return x_out.contiguous(), y_out, b_out


def _perlin_interpolant(t: Tensor) -> Tensor:
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def draw_perlin_lattices(
    generator: torch.Generator, res: T.Tuple[int, int, int]
) -> T.Tuple[Tensor, Tensor]:
    """theta and phi, uniform in [0, 2 pi), on the (res + 1)^3 lattice."""
    lattice = (res[0] + 1, res[1] + 1, res[2] + 1)
    theta = 2 * math.pi * torch.rand(lattice, generator=generator)
    phi = 2 * math.pi * torch.rand(lattice, generator=generator)
    return theta, phi


def perlin_noise_3d(
    theta: Tensor,
    phi: Tensor,
    shape: T.Tuple[int, int, int],
    res: T.Tuple[int, int, int],
    out_range: T.Tuple[float, float] = (-0.03, 0.03),
) -> Tensor:
    """3-D Perlin noise over (T, H, W) from the gradient angles on the
    lattice; shape must be a multiple of res (after github.com/pvigier/
    perlin-numpy, MIT)."""
    for s, r in zip(shape, res):
        if s % r != 0:
            raise ValueError(f"shape {shape} not a multiple of res {res}")

    d = tuple(s // r for s, r in zip(shape, res))
    # Fractional lattice coordinates per voxel.
    grids = [
        (torch.arange(s, dtype=torch.float32) * (r / s)) % 1.0
        for s, r in zip(shape, res)
    ]
    gt = grids[0][:, None, None]
    gh = grids[1][None, :, None]
    gw = grids[2][None, None, :]

    gradients = torch.stack(
        [
            torch.sin(phi) * torch.cos(theta),
            torch.sin(phi) * torch.sin(theta),
            torch.cos(phi),
        ],
        dim=-1,
    )
    gradients = torch.repeat_interleave(gradients, d[0], dim=0)
    gradients = torch.repeat_interleave(gradients, d[1], dim=1)
    gradients = torch.repeat_interleave(gradients, d[2], dim=2)

    def corner(i, j, k):
        g = gradients[
            slice(d[0], None) if i else slice(None, -d[0]),
            slice(d[1], None) if j else slice(None, -d[1]),
            slice(d[2], None) if k else slice(None, -d[2]),
        ]
        offset = torch.stack(
            torch.broadcast_tensors(gt - i, gh - j, gw - k), dim=-1
        )
        return torch.sum(offset * g, dim=-1)

    t = _perlin_interpolant(
        torch.stack(torch.broadcast_tensors(gt, gh, gw), dim=-1)
    )
    n00 = corner(0, 0, 0) * (1 - t[..., 0]) + t[..., 0] * corner(1, 0, 0)
    n10 = corner(0, 1, 0) * (1 - t[..., 0]) + t[..., 0] * corner(1, 1, 0)
    n01 = corner(0, 0, 1) * (1 - t[..., 0]) + t[..., 0] * corner(1, 0, 1)
    n11 = corner(0, 1, 1) * (1 - t[..., 0]) + t[..., 0] * corner(1, 1, 1)
    n0 = (1 - t[..., 1]) * n00 + t[..., 1] * n10
    n1 = (1 - t[..., 1]) * n01 + t[..., 1] * n11
    noise = (1 - t[..., 2]) * n0 + t[..., 2] * n1

    lo, hi = out_range
    return ((hi - lo) * (noise + 0.5)) + lo
