"""Operations, bytes and FLOPs of the model's work, from its shapes, and
the H100's published peaks (NVIDIA data sheet, SXM, dense, 700 W).

The counts depend on the work, not on the kernel that does it:
``count_model`` runs the reference model on the meta device at a cell's
shapes and records the convolutions' and matrix products' FLOPs
(``torch.utils.flop_counter``), each neighborhood-attention and temporal
attention call's shape (their FLOPs by formula: the plain versions are
elementwise products the counter does not see), and each LayerNorm's
input shape. The bounds follow ``chip_smoke.py``'s (``na_bound_ms``,
``na_bwd_bound_ms``, ``temporal_bound_ms``, ``layernorm_bounds``): each
input byte read once and each output byte written once; the compute peak
is the one of the operands' type.
"""

import dataclasses
import math
import typing as T

import torch

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# (B, H, W, heads, head_dim, kernel, dilation)
NaSite = T.Tuple[int, int, int, int, int, int, int]
# (N, Tq, S, C, heads, q_rows): q_rows is N, or 1 where one query row is
# broadcast over the pixels (the pooling query).
TemporalSite = T.Tuple[int, int, int, int, int, int]


def compute_peak(itemsize: int) -> float:
    return BF16_FLOPS if itemsize == 2 else FP32_FLOPS


def least_seconds(bytes_moved: float, ops: float, itemsize: int) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / compute_peak(itemsize))


def na_bytes_ops(site: NaSite, itemsize: int, backward: bool):
    """Forward: q, k, v read, out written; per window slot two dots, the
    exponential, the max and the scale. Backward: q, k, v, g read, dq, dk,
    dv written; logits, g . v, dq, dk and dv, 2 D each a slot, and the
    softmax and its backward."""
    b, h, w, n, d, k, _ = site
    numel = b * h * w * n * d
    slots = b * h * w * n * k * k
    if backward:
        return 7 * numel * itemsize, slots * (10 * d + 8)
    return 4 * numel * itemsize, slots * (4 * d + 3)


def na_flops(site: NaSite, backward: bool) -> float:
    b, h, w, n, d, k, _ = site
    return (8 if backward else 4) * b * h * w * n * k * k * d


def temporal_bytes_ops(site: TemporalSite, itemsize: int, backward: bool):
    """q counted as stored (one Tq x C block where it is broadcast), k, v
    and the output; backward adds g and the three gradients. Operations
    4 S C per (pixel, query step), 10 S C in the backward."""
    n, tq, s, c, _, q_rows = site
    q_elems = q_rows * tq * c
    out_elems, kv_elems = n * tq * c, n * s * c
    if backward:
        return (2 * q_elems + out_elems + 4 * kv_elems) * itemsize, 10 * n * tq * s * c
    return (q_elems + out_elems + 2 * kv_elems) * itemsize, 4 * n * tq * s * c


def temporal_flops(site: TemporalSite, backward: bool) -> float:
    n, tq, s, c, _, _ = site
    return (8 if backward else 4) * n * tq * s * c


def layernorm_bytes(shape: T.Sequence[int], itemsize: int) -> float:
    """Rows x width read once and written once."""
    return 2 * math.prod(shape) * itemsize


@dataclasses.dataclass
class Counts:
    """One call of the model at a cell's shapes."""

    matmul_flops: float  # convolutions and matrix products
    na_sites: T.List[NaSite]
    temporal_sites: T.List[TemporalSite]
    layernorm_shapes: T.List[T.Tuple[int, ...]]
    backward: bool

    def flops(self) -> float:
        return (
            self.matmul_flops
            + sum(na_flops(s, False) for s in self.na_sites)
            + sum(temporal_flops(s, False) for s in self.temporal_sites)
            + (
                sum(na_flops(s, True) for s in self.na_sites)
                + sum(temporal_flops(s, True) for s in self.temporal_sites)
                if self.backward else 0.0
            )
        )

    def na_least_seconds(self, itemsize: int, backward: bool) -> float:
        return sum(
            least_seconds(*na_bytes_ops(s, itemsize, backward), itemsize)
            for s in self.na_sites
        )

    def temporal_least_seconds(self, itemsize: int, backward: bool) -> float:
        return sum(
            least_seconds(*temporal_bytes_ops(s, itemsize, backward), itemsize)
            for s in self.temporal_sites
        )

    def layernorm_least_seconds(self, itemsize: int) -> float:
        return sum(
            layernorm_bytes(s, itemsize) / HBM_BYTES_PER_S
            for s in self.layernorm_shapes
        )


def count_model(
    model_kwargs: T.Mapping[str, T.Any],
    x_shape: T.Sequence[int],
    backward: bool,
) -> Counts:
    """Count one forward (and with ``backward`` its backward) of the
    reference model on an (B, T, H, W, C) input, on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference import attention, temporal
    from .reference.cultionet import CultioNet

    na_sites: T.List[NaSite] = []
    temporal_sites: T.List[TemporalSite] = []
    ln_shapes: T.List[T.Tuple[int, ...]] = []

    def na_stub(q, k, v, kernel_size, dilation=1, attn_drop=0.0, seed=None):
        if kernel_size > 1:  # a one-key window is v itself: no kernel runs
            na_sites.append((*q.shape, kernel_size, dilation))
        return v + 0.0 * (q + k)

    def temporal_stub(q, k, v, num_heads):
        q_rows = 1 if q.stride(0) == 0 else q.shape[0]
        temporal_sites.append(
            (q.shape[0], q.shape[1], k.shape[1], q.shape[2], num_heads, q_rows)
        )
        return q + 0.0 * (k.sum() + v.sum())

    def ln_hook(module, args):
        ln_shapes.append(tuple(args[0].shape))

    saved = (attention.na2d, temporal.temporal_attention)
    attention.na2d, temporal.temporal_attention = na_stub, temporal_stub
    try:
        with torch.device("meta"):
            model = CultioNet(**model_kwargs).eval()
            x = torch.empty(tuple(x_shape))
        hooks = [
            m.register_forward_pre_hook(ln_hook)
            for m in model.modules() if isinstance(m, torch.nn.LayerNorm)
        ]
        counter = FlopCounterMode(display=False)
        with counter:
            out = model(x)
            if backward:
                sum(v.sum() for v in out.values() if v is not None).backward()
        for h in hooks:
            h.remove()
    finally:
        attention.na2d, temporal.temporal_attention = saved
    return Counts(
        matmul_flops=float(counter.get_total_flops()),
        na_sites=na_sites,
        temporal_sites=temporal_sites,
        layernorm_shapes=ln_shapes,
        backward=backward,
    )
