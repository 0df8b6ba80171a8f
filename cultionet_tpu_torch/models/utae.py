"""U-TAE: a U-Net whose encoder is shared over the dates of a satellite
image time series and whose skips are collapsed over time by a
lightweight temporal attention (Garnot & Landrieu, "Panoptic Segmentation
of Satellite Image Time Series with Convolutional Temporal Attention
Networks", ICCV 2021, arXiv:2107.07933; github.com/VSainteuf/utae-paps,
``src/backbones/utae.py`` and ``ltae.py``, the semantic model). A model of
the port alone: the JAX package has none.

Layout (B, T, C, H, W) inside; ``forward`` takes the port's (B, T, H, W, C)
``Batch.x`` and permutes it once. ``date_count`` (B,) says how many of the
T dates of a chip are real: the first ``date_count``, the rest padding.

- ConvLayer(nk, norm, k=3, s=1, p=1): for each consecutive pair of ``nk``,
  ``Conv2d(k, s, p, padding_mode="reflect", bias)``, the norm, ReLU.
- Encoder, its weights shared over dates, each date image computed alone,
  GroupNorm with 4 groups: ``e0 = ConvLayer([C, 64, 64])`` at H x W; three
  ``DownConvBlock(d_in, d_out)``: ``y = ConvLayer([d_in, d_in], k=4, s=2,
  p=1)(x)``, ``y = ConvLayer([d_in, d_out])(y)``, ``out = y +
  ConvLayer([d_out, d_out])(y)``, 64->64, 64->64, 64->128, giving e1, e2,
  e3. After every block the outputs of pad dates are set to 0 (the
  published ``smart_forward`` fills them with the pad value; here every
  date is computed and the pads zeroed, which GroupNorm's per-image
  statistics make the same).
- L-TAE on e3, one sequence per pixel (B h w, T, 128): ``GroupNorm(16,
  128)`` over (channels, T), the zeroed pad dates in its statistics as
  published; a 1x1 ``Conv1d`` 128->256; plus the date encoding
  ``pe[2i] = sin(day / 1000^(2i/16))``, ``pe[2i+1] = cos(...)`` over 16
  dimensions repeated 16 times; 16 heads of d_k 4: keys ``Linear(256 ->
  64)``, one learned query per head shared by every pixel, ``score = q.k
  / sqrt(d_k)``, -1000 at pad dates, softmax over T, dropout 0.1 on the
  weights; values the 256 channels in 16 groups of 16, ``out_h = sum_t
  a_ht v_ht``, heads concatenated; ``Linear(256 -> 128)``,
  ``BatchNorm1d``, ReLU, dropout 0.2, ``GroupNorm(16, 128)``. It returns
  the attention maps ``a`` (16, B, T, h, w) after their dropout, as
  published.
- Aggregation at e2, e1, e0 (64 channels): ``a`` resized bilinearly
  (``align_corners=False``) to the level, times (1 - pad), the channels in
  16 groups of 4, ``skip_h = sum_t a_ht e[:, t, group h]``, heads
  concatenated.
- Decoder, BatchNorm: ``UpConvBlock(d_in, d_out, d_skip)``: ``u =
  ReLU(BN(ConvTranspose2d(d_in -> d_out, 4, 2, 1)(x)))``, ``s =
  ReLU(BN(Conv1x1(skip)))``, ``y = ConvLayer([d_out + d_skip,
  d_out])(cat[u, s])``, ``out = y + ConvLayer([d_out, d_out])(y)``;
  128->64 with e2, 64->32 with e1, 32->32 with e0; the head
  ``ConvLayer([32, 32, K])`` with BatchNorm and ReLU after its last layer
  too (the published ``ConvBlock``'s ``last_relu``).

Output: the class logits (B, H, W, K), channels last as the port's other
outputs, under ``InferenceNames.CROP_TYPE``. The parameter names are the
published module's. BatchNorm normalizes with the batch statistics in the
compute type and updates torch's running statistics (momentum 0.1, the
unbiased variance) from fp32 ones; dropout draws from the step's
generator (``nn/dropout.py``). Spans ``utae.encode``, ``utae.temporal``,
``utae.aggregate`` and ``utae.decode`` (``utils/profiling.py``) mark the
forward's phases.
"""

import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from ..enums import InferenceNames
from ..nn.dropout import Dropout
from ..utils.profiling import span

Tensor = torch.Tensor


def date_mask(date_count: T.Optional[Tensor], steps: int, batch: int, device) -> Tensor:
    """(B, T) True at the real dates: the first ``date_count`` of each
    chip; every date where ``date_count`` is None."""
    if date_count is None:
        return torch.ones((batch, steps), dtype=torch.bool, device=device)
    position = torch.arange(steps, device=date_count.device)
    return position[None, :] < date_count.to(torch.int64)[:, None]


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """torch's BatchNorm over (N, C) or (N, C, H, W) (eps 1e-5, momentum
    0.1): training normalizes with the batch statistics in the input's
    type and updates the running mean and unbiased variance from fp32
    statistics; eval normalizes with the running ones."""

    def _check_input_dim(self, x: Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"expected a 2-D or 4-D input, got {x.dim()}-D")

    def forward(self, x: Tensor) -> Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(
                x, self.running_mean.to(x.dtype), self.running_var.to(x.dtype),
                self.weight, self.bias, False, 0.0, self.eps,
            )
        with torch.no_grad():
            dims = (0,) if x.dim() == 2 else (0, 2, 3)
            var, mean = torch.var_mean(
                x.to(self.running_mean.dtype), dim=dims, correction=1
            )
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvLayer(nn.Module):
    def __init__(
        self,
        nkernels: T.Sequence[int],
        norm: str = "batch",
        k: int = 3,
        s: int = 1,
        p: int = 1,
        n_groups: int = 4,
        last_relu: bool = True,
        padding_mode: str = "reflect",
    ):
        super().__init__()
        if norm not in ("batch", "group"):
            raise ValueError(f"norm must be 'batch' or 'group', got {norm!r}")
        layers: T.List[nn.Module] = []
        for i in range(len(nkernels) - 1):
            width = nkernels[i + 1]
            layers.append(
                nn.Conv2d(nkernels[i], width, kernel_size=k, padding=p, stride=s,
                          padding_mode=padding_mode)
            )
            layers.append(BatchNorm(width) if norm == "batch" else nn.GroupNorm(n_groups, width))
            if last_relu or i < len(nkernels) - 2:
                layers.append(nn.ReLU())
        self.conv = nn.Sequential(*layers)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(x)


class ConvBlock(nn.Module):
    def __init__(self, nkernels: T.Sequence[int], norm: str = "batch",
                 padding_mode: str = "reflect"):
        super().__init__()
        self.conv = ConvLayer(nkernels, norm=norm, padding_mode=padding_mode)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(x)


class DownConvBlock(nn.Module):
    def __init__(self, d_in: int, d_out: int, k: int, s: int, p: int,
                 norm: str = "batch", padding_mode: str = "reflect"):
        super().__init__()
        self.down = ConvLayer([d_in, d_in], norm=norm, k=k, s=s, p=p, padding_mode=padding_mode)
        self.conv1 = ConvLayer([d_in, d_out], norm=norm, padding_mode=padding_mode)
        self.conv2 = ConvLayer([d_out, d_out], norm=norm, padding_mode=padding_mode)

    def forward(self, x: Tensor) -> Tensor:
        out = self.conv1(self.down(x))
        return out + self.conv2(out)


class UpConvBlock(nn.Module):
    def __init__(self, d_in: int, d_out: int, k: int, s: int, p: int, d_skip: int,
                 padding_mode: str = "reflect"):
        super().__init__()
        self.skip_conv = nn.Sequential(
            nn.Conv2d(d_skip, d_skip, kernel_size=1), BatchNorm(d_skip), nn.ReLU()
        )
        self.up = nn.Sequential(
            nn.ConvTranspose2d(d_in, d_out, kernel_size=k, stride=s, padding=p),
            BatchNorm(d_out),
            nn.ReLU(),
        )
        self.conv1 = ConvLayer([d_out + d_skip, d_out], padding_mode=padding_mode)
        self.conv2 = ConvLayer([d_out, d_out], padding_mode=padding_mode)

    def forward(self, x: Tensor, skip: Tensor) -> Tensor:
        out = torch.cat([self.up(x), self.skip_conv(skip)], dim=1)
        out = self.conv1(out)
        return out + self.conv2(out)


class PositionalEncoder(nn.Module):
    """The sinusoid of the acquisition day over ``d`` dimensions (period
    base ``T``), repeated ``repeat`` times."""

    def __init__(self, d: int, T: float = 1000.0, repeat: int = 1):
        super().__init__()
        self.repeat = repeat
        denom = torch.pow(T, 2 * (torch.arange(d) // 2).float() / d)
        self.register_buffer("denom", denom, persistent=False)
        self.register_buffer("even", torch.arange(d) % 2 == 0, persistent=False)

    def forward(self, days: Tensor) -> Tensor:
        """(B, T) days -> (B, T, d * repeat) in the buffers' type (fp32)."""
        table = days.to(self.denom.dtype)[..., None] / self.denom
        table = torch.where(self.even, torch.sin(table), torch.cos(table))
        return table.repeat(1, 1, self.repeat)


class MultiHeadAttention(nn.Module):
    """L-TAE's heads: one learned query per head, keys of width ``d_k``
    from the input, values the input's channel groups."""

    def __init__(self, n_head: int, d_k: int, d_in: int, attn_dropout: float = 0.1):
        super().__init__()
        self.n_head, self.d_k = n_head, d_k
        self.Q = nn.Parameter(torch.zeros((n_head, d_k)))
        self.normal_init = {"Q": (2.0 / d_k) ** 0.5}
        self.fc1_k = nn.Linear(d_in, n_head * d_k)
        self.dropout = Dropout(attn_dropout)

    def forward(self, v: Tensor, pad: T.Optional[Tensor]) -> T.Tuple[Tensor, Tensor]:
        """v (N, T, d_in), pad (N, T) True at pad dates -> (N, d_in) and
        the weights (n_head, N, T)."""
        n, steps, d_in = v.shape
        k = self.fc1_k(v).view(n, steps, self.n_head, self.d_k)
        # Head-major, as the published heads stack their rows.
        scores = torch.einsum("nthd,hd->hnt", k, self.Q) / self.d_k**0.5
        if pad is not None:
            scores = scores.masked_fill(pad[None], -1000.0)
        attn = self.dropout(torch.softmax(scores, dim=-1))
        values = v.view(n, steps, self.n_head, d_in // self.n_head)
        out = torch.einsum("hnt,nthc->nhc", attn, values)
        return out.reshape(n, d_in), attn


class LTAE2d(nn.Module):
    def __init__(self, in_channels: int = 128, n_head: int = 16, d_k: int = 4,
                 d_model: int = 256, dropout: float = 0.2, T: float = 1000.0):
        super().__init__()
        self.n_head = n_head
        self.in_norm = nn.GroupNorm(n_head, in_channels)
        self.inconv = nn.Conv1d(in_channels, d_model, 1)
        self.positional_encoder = PositionalEncoder(d_model // n_head, T=T, repeat=n_head)
        self.attention_heads = MultiHeadAttention(n_head, d_k, d_model)
        self.mlp = nn.Sequential(nn.Linear(d_model, in_channels), BatchNorm(in_channels), nn.ReLU())
        self.dropout = Dropout(dropout)
        self.out_norm = nn.GroupNorm(n_head, in_channels)

    def forward(self, x: Tensor, days: Tensor, valid: Tensor) -> T.Tuple[Tensor, Tensor]:
        """x (B, T, C, h, w), days (B, T), valid (B, T) -> (B, C, h, w) and
        the attention maps (n_head, B, T, h, w)."""
        b, steps, c, h, w = x.shape
        n = b * h * w
        out = x.permute(0, 3, 4, 2, 1).reshape(n, c, steps)
        out = self.inconv(self.in_norm(out)).transpose(1, 2)  # (N, T, d_model)
        pe = self.positional_encoder(days).to(out.dtype)
        out = (out.view(b, h * w, steps, -1) + pe[:, None]).view(n, steps, -1)
        pad = (~valid)[:, None, :].expand(b, h * w, steps).reshape(n, steps)
        out, attn = self.attention_heads(out, pad)
        out = self.out_norm(self.dropout(self.mlp(out)))
        out = out.view(b, h, w, -1).permute(0, 3, 1, 2)
        attn = attn.view(self.n_head, b, h, w, steps).permute(0, 1, 4, 2, 3)
        return out, attn


def aggregate(x: Tensor, attn: Tensor, valid: Tensor) -> Tensor:
    """Group-wise attention-weighted sum over time: x (B, T, C, S, S),
    attn (n_head, B, T, h, w), valid (B, T) -> (B, C, S, S); head ``h``
    weighs the channel group ``h`` of C / n_head channels."""
    n_head, b, steps, h, w = attn.shape
    size = x.shape[-2:]
    # Resized in fp32 at least: the resize's backward sums each coarse
    # pixel's gradient from the many fine pixels it feeds with atomic adds,
    # which in bf16 lose most of the sum's precision.
    a = attn.reshape(n_head * b, steps, h, w)
    a = a.to(torch.promote_types(a.dtype, torch.float32))
    if tuple(size) != (h, w):
        a = F.interpolate(a, size=size, mode="bilinear", align_corners=False)
    a = a.view(n_head, b, steps, *size) * valid[None, :, :, None, None].to(a.dtype)
    a = a.to(x.dtype)
    groups = x.view(b, steps, n_head, x.shape[2] // n_head, *size)
    out = (a.permute(1, 2, 0, 3, 4).unsqueeze(3) * groups).sum(dim=1)
    return out.reshape(b, x.shape[2], *size)


class UTAE(nn.Module):
    """U-TAE for semantic segmentation, as ``train_semantic.py`` builds it
    (the published defaults below). ``hidden_channels`` is the width the
    port's configuration carries: it must equal ``encoder_widths[0]``.
    ``in_time`` is accepted for the configuration's sake; any T runs."""

    def __init__(
        self,
        in_channels: int = 10,
        hidden_channels: int = 64,
        in_time: T.Optional[int] = None,
        model_type: str = "UTAE",
        encoder_widths: T.Sequence[int] = (64, 64, 64, 128),
        decoder_widths: T.Sequence[int] = (32, 32, 64, 128),
        out_conv: T.Sequence[int] = (32, 20),
        str_conv_k: int = 4,
        str_conv_s: int = 2,
        str_conv_p: int = 1,
        agg_mode: str = "att_group",
        encoder_norm: str = "group",
        n_head: int = 16,
        d_model: int = 256,
        d_k: int = 4,
        pad_value: float = 0.0,
        padding_mode: str = "reflect",
    ):
        super().__init__()
        if hidden_channels != encoder_widths[0]:
            raise ValueError(
                f"hidden_channels {hidden_channels} must equal encoder_widths[0] "
                f"{encoder_widths[0]}"
            )
        if len(encoder_widths) != len(decoder_widths) or encoder_widths[-1] != decoder_widths[-1]:
            raise ValueError("encoder and decoder widths must pair, ending equal")
        if agg_mode != "att_group" or pad_value != 0:
            raise ValueError("the port builds agg_mode 'att_group' with pad value 0")
        self.num_classes = out_conv[-1]
        stages = len(encoder_widths)
        self.in_conv = ConvBlock(
            [in_channels, encoder_widths[0], encoder_widths[0]], norm=encoder_norm,
            padding_mode=padding_mode,
        )
        self.down_blocks = nn.ModuleList(
            DownConvBlock(encoder_widths[i], encoder_widths[i + 1], str_conv_k, str_conv_s,
                          str_conv_p, norm=encoder_norm, padding_mode=padding_mode)
            for i in range(stages - 1)
        )
        self.up_blocks = nn.ModuleList(
            UpConvBlock(decoder_widths[i], decoder_widths[i - 1], str_conv_k, str_conv_s,
                        str_conv_p, d_skip=encoder_widths[i - 1], padding_mode=padding_mode)
            for i in range(stages - 1, 0, -1)
        )
        self.temporal_encoder = LTAE2d(encoder_widths[-1], n_head=n_head, d_k=d_k,
                                       d_model=d_model)
        self.out_conv = ConvBlock([decoder_widths[0], *out_conv], padding_mode=padding_mode)

    def forward(
        self,
        x: Tensor,
        lat: T.Optional[Tensor] = None,
        lon: T.Optional[Tensor] = None,
        dates: T.Optional[Tensor] = None,
        date_count: T.Optional[Tensor] = None,
    ) -> T.Dict[str, Tensor]:
        """x (B, T, H, W, C); ``dates`` (B, T) acquisition days (the date
        index where None); ``date_count`` (B,) real dates a chip (all where
        None). ``lat`` and ``lon`` are not read."""
        b, steps, height, width, _ = x.shape
        valid = date_mask(date_count, steps, b, x.device)
        if dates is None:
            dates = torch.arange(steps, device=x.device).expand(b, steps)
        with span("utae.encode"):
            out = x.permute(0, 1, 4, 2, 3).reshape(b * steps, -1, height, width)
            keep = valid.reshape(b * steps, 1, 1, 1).to(out.dtype)
            out = self.in_conv(out) * keep
            features = [out]
            for block in self.down_blocks:
                out = block(out) * keep
                features.append(out)
        with span("utae.temporal"):
            last = features[-1]
            out, attn = self.temporal_encoder(
                last.view(b, steps, *last.shape[1:]), dates, valid
            )
        for i, block in enumerate(self.up_blocks):
            level = features[-(i + 2)]
            with span("utae.aggregate"):
                skip = aggregate(level.view(b, steps, *level.shape[1:]), attn, valid)
            with span("utae.decode"):
                out = block(out, skip)
        with span("utae.decode"):
            logits = self.out_conv(out)
        return {InferenceNames.CROP_TYPE: logits.permute(0, 2, 3, 1)}
