"""In-step batch augmentation on the device (port of
cultionet_tpu/augment/device.py).

Each sample draws one of the 8 dihedral transforms of its (H, W) grid
(code ``k + 4 * flip``: flip W first when ``flip``, then ``rot90`` k times
over (H, W), the JAX package's ``_apply_one``), and optionally additive
Gaussian noise on x, not clipped afterwards. The transforms are one
index-mapped gather per field: the 8 pixel permutations of a square grid
are built once per size and device, and each sample gathers its pixels
through its code's permutation, so there is no loop over samples and no
host synchronisation. Codes and noise draw from the step's generator, on
its device.
"""

import functools
import typing as T

import torch

from ..data.batch import Batch

Tensor = torch.Tensor


@functools.lru_cache(maxsize=16)
def dihedral_maps(size: int, device: torch.device) -> Tensor:
    """(8, size * size) source pixel of each output pixel, for each code:
    the transform applied to the grid of flat pixel indices (read only)."""
    grid = torch.arange(size * size, device=device).reshape(size, size)
    maps = []
    for flip in (False, True):
        for k in range(4):
            image = torch.flip(grid, dims=(1,)) if flip else grid
            maps.append(torch.rot90(image, k=k, dims=(0, 1)).reshape(-1))
    return torch.stack(maps)


def apply_dihedral(
    x: Tensor, y: T.Optional[Tensor], bdist: T.Optional[Tensor], codes: Tensor
) -> T.Tuple[Tensor, T.Optional[Tensor], T.Optional[Tensor]]:
    """Sample ``b`` of x (B, T, H, W, C), y and bdist (B, H, W) through
    transform ``codes[b]``; None passes through."""
    num, steps, height, width, channels = x.shape
    if height != width:
        raise ValueError(
            f"device dihedral augmentation needs square chips, got "
            f"{height} x {width}"
        )
    src = dihedral_maps(height, x.device)[codes]  # (B, H*W)
    x = x.reshape(num, steps, height * width, channels).gather(
        2, src[:, None, :, None].expand(num, steps, height * width, channels)
    )

    def grid(value: T.Optional[Tensor]) -> T.Optional[Tensor]:
        if value is None:
            return None
        return value.reshape(num, height * width).gather(1, src).reshape(
            num, height, width
        )

    return x.reshape(num, steps, height, width, channels), grid(y), grid(bdist)


def augment_batch_on_device(
    batch: Batch,
    generator: torch.Generator,
    dihedral: bool = True,
    noise_sigma: float = 0.0,
) -> Batch:
    """A random dihedral transform per sample (``dihedral``) and additive
    Gaussian noise of std ``noise_sigma`` on x (when > 0), drawn from
    ``generator`` in that order; y or bdist None passes through."""
    if not dihedral and noise_sigma <= 0:
        return batch
    x, y, bdist = batch.x, batch.y, batch.bdist
    if dihedral:
        codes = torch.randint(
            0, 8, (x.shape[0],), generator=generator, device=generator.device
        )
        x, y, bdist = apply_dihedral(x, y, bdist, codes.to(x.device))
    if noise_sigma > 0:
        # No clipping: x may be z-scored (unbounded) here.
        noise = torch.randn(
            x.shape, generator=generator, device=generator.device, dtype=x.dtype
        )
        x = x + noise_sigma * noise.to(x.device)
    return batch.replace(x=x, y=y, bdist=bdist)
