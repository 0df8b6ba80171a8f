"""TSViT: a vision transformer for satellite image time series that
attends over time first, then over space, with one token per class
(Tarasiou, Chavez & Zafeiriou, "ViTs for SITS: Vision Transformers for
Satellite Image Time Series", CVPR 2023, arXiv:2301.04944;
github.com/michaeltrs/DeepSatModels, ``models/TSViT/TSViTdense.py`` and
``module.py``, the semantic model). A model of the port alone: the JAX
package has none.

``forward`` takes the port's (B, T, H, W, C) ``Batch.x`` with ``dates``
(B, T), the acquisition days counted from the first of September, and
``date_count`` (B,), the real dates of each chip (the first
``date_count``, the rest padding). With K classes, p the patch size, N =
(H / p)(W / p) patches and width d:

- Patch embedding: ``(b h w) t (p1 p2 c)`` -> ``Linear(p^2 C, d)``.
- Date embedding: the day of year ``(day + 243) mod 365`` (September 1 is
  day of year 243, counted from 0) as a one-hot of 366 through
  ``Linear(366, d)``, added to every patch token of that date. A pad date
  has input 0 and day of year 0, as the published ``CutOrPad`` leaves
  its zero rows; it is computed and attended to like any other date (the
  published forward takes no lengths).
- K learned class tokens before each patch's T date tokens; the temporal
  encoder over B N sequences of K + T tokens, through
  ``ops/temporal.py::temporal_attention`` (the hand-written kernels
  ``temporal_fwd`` / ``temporal_bwd`` on the card).
- The K class outputs regrouped as B K sequences of N tokens, a learned
  position embedding added; the spatial encoder over them, through
  ``scaled_dot_product_attention``.
- The head ``LayerNorm`` -> ``Linear(d, p^2)``: each class's stream gives
  that class's logits for the p x p pixels of each patch, put back in the
  patch's own block (the inverse of the embedding's rearrange; the
  published reshape orders them otherwise).

Each encoder layer is pre-norm: ``x + MHSA(LN(x))`` (qkv without bias, the
heads side by side along the width, an out-projection with bias), then
``x + FF(LN(x))`` (``Linear(d, 4d)``, exact GELU, ``Linear(4d, d)``); a
final LayerNorm closes each encoder. Each LayerNorm module's parameters go
through ``ops/layer_norm.py::layer_norm_rows`` (on the card the
hand-written LayerNorm kernels, forward and backward). Dropout is 0, as
published, and the port builds no other. Output: the class logits (B, H,
W, K) under ``InferenceNames.CROP_TYPE``. Parameter names are the
published module's.
Spans ``tsvit.embed``, ``tsvit.temporal``, ``tsvit.spatial`` and
``tsvit.head`` (``utils/profiling.py``) mark the forward's phases.
"""

import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from ..enums import InferenceNames
from ..ops.layer_norm import layer_norm_rows
from ..ops.temporal import temporal_attention
from ..utils.profiling import span
from .utae import date_mask

Tensor = torch.Tensor

DAYS = 366
# The traffic's days count from September 1, day of year 243 from 0.
FIRST_DAY_OF_YEAR = 243


def day_of_year(dates: Tensor, valid: Tensor) -> Tensor:
    """(B, T) int64 day of year of each date, 0 at pad dates."""
    doy = (dates.to(torch.int64) + FIRST_DAY_OF_YEAR) % 365
    return torch.where(valid, doy, torch.zeros_like(doy))


def patchify(x: Tensor, patch: int) -> Tensor:
    """(B, T, H, W, C) -> (B h w, T, p p C), as ``b t c (h p1) (w p2) ->
    (b h w) t (p1 p2 c)``."""
    b, steps, height, width, c = x.shape
    h, w = height // patch, width // patch
    x = x.reshape(b, steps, h, patch, w, patch, c).permute(0, 2, 4, 1, 3, 5, 6)
    return x.reshape(b * h * w, steps, patch * patch * c)


def unpatchify(x: Tensor, b: int, k: int, h: int, w: int, patch: int) -> Tensor:
    """(B K, h w, p p) class-stream outputs -> (B, h p, w p, K) logits,
    each patch's p x p outputs back in its own block."""
    x = x.reshape(b, k, h, w, patch, patch).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, h * patch, w * patch, k)


def layer_norm(m: nn.LayerNorm, x: Tensor) -> Tensor:
    """``m(x)`` through ``layer_norm_rows``."""
    return layer_norm_rows(x, m.weight, m.bias, m.eps)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn

    def forward(self, x: Tensor) -> Tensor:
        return self.fn(layer_norm(self.norm, x))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        # The published Sequential's indices: Linear, GELU, Dropout,
        # Linear, Dropout (the dropouts at 0).
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim), nn.GELU(), nn.Identity(),
            nn.Linear(hidden_dim, dim), nn.Identity(),
        )

    def forward(self, x: Tensor) -> Tensor:
        return self.net(x)


class Attention(nn.Module):
    """Multi-head self-attention over the sequence axis of (N, S, d):
    ``temporal`` through the port's temporal attention op, else through
    ``scaled_dot_product_attention``."""

    def __init__(self, dim: int, heads: int, dim_head: int, temporal: bool):
        super().__init__()
        inner = heads * dim_head
        if heads == 1 and dim_head == dim:
            raise ValueError("the port builds TSViT's attention with its out-projection")
        self.heads, self.temporal = heads, temporal
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Identity())

    def forward(self, x: Tensor) -> Tensor:
        n, steps, _ = x.shape
        # q, k and v stay the thirds of one projection: the kernels then
        # copy each sequence's rows as one range.
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        if self.temporal:
            out = temporal_attention(q, k, v, self.heads)
        else:
            q, k, v = (t.unflatten(-1, (self.heads, -1)).transpose(1, 2) for t in (q, k, v))
            out = F.scaled_dot_product_attention(q, k, v)
            out = out.transpose(1, 2).reshape(n, steps, -1)
        return self.to_out(out)


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 temporal: bool):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([
                PreNorm(dim, Attention(dim, heads, dim_head, temporal)),
                PreNorm(dim, FeedForward(dim, mlp_dim)),
            ])
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(dim)

    def forward(self, x: Tensor) -> Tensor:
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return layer_norm(self.norm, x)


class TSViT(nn.Module):
    """TSViT for semantic segmentation, the PASTIS24 setting by default.
    ``hidden_channels`` is the width the port's configuration carries: it
    must equal ``dim``. ``in_time`` is accepted for the configuration's
    sake; any T runs (the dates are embedded by day of year)."""

    def __init__(
        self,
        in_channels: int = 10,
        hidden_channels: int = 128,
        in_time: T.Optional[int] = None,
        model_type: str = "TSViT",
        img_res: int = 24,
        patch_size: int = 2,
        num_classes: int = 19,
        dim: int = 128,
        temporal_depth: int = 4,
        spatial_depth: int = 4,
        heads: int = 4,
        dim_head: int = 32,
        scale_dim: int = 4,
        dropout: float = 0.0,
        emb_dropout: float = 0.0,
    ):
        super().__init__()
        if hidden_channels != dim:
            raise ValueError(f"hidden_channels {hidden_channels} must equal dim {dim}")
        if img_res % patch_size:
            raise ValueError(f"patch_size {patch_size} must divide img_res {img_res}")
        if dropout or emb_dropout:
            raise ValueError("the port builds TSViT with dropout 0, as published")
        self.img_res, self.patch_size, self.num_classes = img_res, patch_size, num_classes
        num_patches = (img_res // patch_size) ** 2
        self.to_patch_embedding = nn.Sequential(
            nn.Identity(), nn.Linear(in_channels * patch_size**2, dim)
        )
        self.to_temporal_embedding_input = nn.Linear(DAYS, dim)
        self.temporal_token = nn.Parameter(torch.randn(1, num_classes, dim))
        self.temporal_transformer = Transformer(
            dim, temporal_depth, heads, dim_head, dim * scale_dim, temporal=True
        )
        self.space_pos_embedding = nn.Parameter(torch.randn(1, num_patches, dim))
        self.space_transformer = Transformer(
            dim, spatial_depth, heads, dim_head, dim * scale_dim, temporal=False
        )
        self.mlp_head = nn.Sequential(nn.LayerNorm(dim), nn.Linear(dim, patch_size**2))

    def forward(
        self,
        x: Tensor,
        lat: T.Optional[Tensor] = None,
        lon: T.Optional[Tensor] = None,
        dates: T.Optional[Tensor] = None,
        date_count: T.Optional[Tensor] = None,
    ) -> T.Dict[str, Tensor]:
        """x (B, T, H, W, C); ``dates`` (B, T) days from September 1 (the
        date index where None); ``date_count`` (B,) real dates a chip (all
        where None). ``lat`` and ``lon`` are not read."""
        b, steps, height, width, _ = x.shape
        if (height, width) != (self.img_res, self.img_res):
            raise ValueError(
                f"TSViT of img_res {self.img_res} got {height} x {width} chips"
            )
        p, k = self.patch_size, self.num_classes
        h, w = height // p, width // p
        valid = date_mask(date_count, steps, b, x.device)
        if dates is None:
            dates = torch.arange(steps, device=x.device).expand(b, steps)
        with span("tsvit.embed"):
            x = x * valid[:, :, None, None, None].to(x.dtype)
            out = self.to_patch_embedding(patchify(x, p))  # (B N, T, d)
            table = self.to_temporal_embedding_input
            # The one-hot's product with the weight is the weight's column.
            when = table.weight.t()[day_of_year(dates, valid)] + table.bias  # (B, T, d)
            out = (out.unflatten(0, (b, h * w)) + when[:, None]).flatten(0, 1)
            tokens = self.temporal_token.expand(out.shape[0], -1, -1)
            out = torch.cat([tokens, out], dim=1)
        with span("tsvit.temporal"):
            out = self.temporal_transformer(out)[:, :k]  # (B N, K, d)
        with span("tsvit.spatial"):
            out = out.unflatten(0, (b, h * w)).transpose(1, 2).flatten(0, 1)
            out = self.space_transformer(out + self.space_pos_embedding)  # (B K, N, d)
        with span("tsvit.head"):
            norm, project = self.mlp_head
            logits = unpatchify(project(layer_norm(norm, out)), b, k, h, w, p)
        return {InferenceNames.CROP_TYPE: logits}
