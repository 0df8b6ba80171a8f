"""TowerUNet structural parts (NCHW): encoder, decoder, fusion towers and
heads, as the CLI-default model builds them (ResUNet-a blocks, no
attention in the encoder and the fusion towers, one class, both head
activations). Output heads return NCHW maps; the model's public forward
turns them channels-last.
"""

import typing as T

import torch
from torch import nn

from .enums import AttentionTypes, InferenceNames
from .blocks import ConvBlock2d, ConvTranspose2d, PoolResidualConv, ResidualAConv

Tensor = torch.Tensor

NATTEN_PARAMS = {
    "a": dict(natten_num_heads=4, natten_kernel_size=3, natten_dilation=2),
    "b": dict(natten_num_heads=4, natten_kernel_size=3, natten_dilation=1),
    "c": dict(natten_num_heads=8, natten_kernel_size=3, natten_dilation=1),
    "d": dict(natten_num_heads=8, natten_kernel_size=1, natten_dilation=1),
}


class SigmoidCrisp(nn.Module):
    """Learnable-temperature sigmoid."""

    def __init__(self, smooth: float = 1e-2):
        super().__init__()
        self.smooth = smooth
        self.gamma = nn.Parameter(torch.ones(1))

    def forward(self, x: Tensor) -> Tensor:
        scale = 1.0 / (self.smooth + torch.sigmoid(self.gamma))
        return torch.sigmoid(x * scale)


class StreamConv2d(nn.Module):
    """in -> hidden -> out task-stream conv."""

    def __init__(
        self,
        in_channels: int,
        hidden_channels: int,
        out_channels: int,
        activation_type: str = "SiLU",
    ):
        super().__init__()
        self.ConvBlock2d_0 = ConvBlock2d(
            in_channels,
            hidden_channels,
            kernel_size=3,
            padding=1,
            activation_type=activation_type,
        )
        self.Conv_0 = nn.Conv2d(hidden_channels, out_channels, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        return self.Conv_0(self.ConvBlock2d_0(x))


class TowerUNetFinal(nn.Module):
    """Psi-Net style multi-stream head for one tower (unpacked streams)."""

    def __init__(
        self,
        in_channels: int,
        activation_type: str = "SiLU",
        resample_factor: int = 0,
    ):
        super().__init__()
        self.up_conv = (
            ConvTranspose2d(in_channels, in_channels, stride=resample_factor)
            if resample_factor > 0
            else None
        )
        self.dist_conv = StreamConv2d(in_channels, 3, 1, activation_type)
        self.edge_conv = StreamConv2d(in_channels, 3, 1, activation_type)
        self.crop_conv = StreamConv2d(in_channels, 3, 1, activation_type)
        self.fuse_conv = ConvBlock2d(
            3, 3, kernel_size=3, padding=1, activation_type=activation_type
        )

    def forward(
        self,
        x: Tensor,
        size: T.Optional[T.Tuple[int, int]] = None,
        suffix: str = "",
    ) -> T.Dict[str, Tensor]:
        if size is not None:
            x = self.up_conv(x, size)
        h = torch.cat(
            [self.dist_conv(x), self.edge_conv(x), self.crop_conv(x)], dim=1
        )
        dist_out, edge_out, mask_out = self.fuse_conv(h).split(1, dim=1)
        return {
            f"{InferenceNames.DISTANCE}{suffix}": dist_out,
            f"{InferenceNames.EDGE}{suffix}": edge_out,
            f"{InferenceNames.CROP}{suffix}": mask_out,
        }


class TowerUNetFinalCombine(nn.Module):
    """Learnable reciprocal-gamma weighted fusion of the three towers, then
    sigmoid (distance, crop) and SigmoidCrisp (edge)."""

    def __init__(self):
        super().__init__()
        for name in ("dist", "edge", "crop"):
            for i in (1, 2, 3):
                self.register_parameter(
                    f"{name}_gamma{i}", nn.Parameter(torch.ones(1))
                )
            self.add_module(f"final_{name}", nn.Conv2d(1, 1, 1))
        self.edge_crisp = SigmoidCrisp()

    def _combine(self, task: str, name: str, parts) -> Tensor:
        total = 0.0
        for i, (suffix, part) in enumerate(parts, start=1):
            total = total + part[f"{task}{suffix}"] / getattr(
                self, f"{name}_gamma{i}"
            )
        return getattr(self, f"final_{name}")(total)

    def forward(
        self,
        out_a: T.Dict[str, Tensor],
        out_b: T.Dict[str, Tensor],
        out_c: T.Dict[str, Tensor],
    ) -> T.Dict[str, Tensor]:
        parts = (("_a", out_a), ("_b", out_b), ("_c", out_c))
        return {
            InferenceNames.DISTANCE: torch.sigmoid(
                self._combine(InferenceNames.DISTANCE, "dist", parts)
            ),
            InferenceNames.EDGE: self.edge_crisp(
                self._combine(InferenceNames.EDGE, "edge", parts)
            ),
            InferenceNames.CROP: torch.sigmoid(
                self._combine(InferenceNames.CROP, "crop", parts)
            ),
        }


class UNetUpBlock(nn.Module):
    """Transposed-conv upsample + residual block. ``resample_up`` says
    whether the block owns an ``up_conv``; it is applied when the input's
    size differs from the requested one."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        attention_weights: T.Optional[str] = None,
        activation_type: str = "SiLU",
        dilations: T.Optional[T.Sequence[int]] = None,
        resample_up: bool = True,
        **natten,
    ):
        super().__init__()
        self.up_conv = (
            ConvTranspose2d(in_channels, in_channels) if resample_up else None
        )
        self.res_conv = ResidualAConv(
            in_channels,
            out_channels,
            kernel_size=kernel_size,
            dilations=dilations,
            attention_weights=attention_weights,
            activation_type=activation_type,
            **natten,
        )

    def forward(self, x: Tensor, size: T.Tuple[int, int]) -> Tensor:
        if tuple(x.shape[-2:]) != tuple(size):
            if self.up_conv is None:
                raise ValueError(
                    f"UNetUpBlock without up_conv got {tuple(x.shape[-2:])}, "
                    f"needs {tuple(size)}"
                )
            x = self.up_conv(x, size)
        return self.res_conv(x)


class TowerUNetEncoder(nn.Module):
    """4-stage backbone at 1/1, 1/2, 1/4, 1/8 resolution (no attention)."""

    def __init__(
        self,
        in_channels: int,
        channels: T.Sequence[int],
        dilations: T.Optional[T.Sequence[int]] = None,
        activation_type: str = "SiLU",
        dropout: float = 0.0,
    ):
        super().__init__()
        dilations = list(dilations) if dilations is not None else [1, 2]
        common = dict(dropout=dropout, activation_type=activation_type)
        self.down_a = PoolResidualConv(
            in_channels, channels[0], dilations=dilations, pool_first=False,
            **common,
        )
        self.down_b = PoolResidualConv(
            channels[0], channels[1], dilations=dilations[:3], **common
        )
        self.down_c = PoolResidualConv(
            channels[1], channels[2], dilations=dilations[:2], **common
        )
        self.down_d = PoolResidualConv(
            channels[2],
            channels[3],
            kernel_size=1,
            num_blocks=1,
            dilations=[1],
            **common,
        )

    def forward(self, x: Tensor) -> T.Dict[str, Tensor]:
        x_a = self.down_a(x)
        x_b = self.down_b(x_a)
        x_c = self.down_c(x_b)
        x_d = self.down_d(x_c)
        return {"x_a": x_a, "x_b": x_b, "x_c": x_c, "x_d": x_d}


class TowerUNetDecoder(nn.Module):
    """1/8 bottleneck + 3 up blocks, all at ``up_channels``. The up blocks
    hold the model's neighborhood attention."""

    def __init__(
        self,
        channels: T.Sequence[int],
        up_channels: int,
        dilations: T.Optional[T.Sequence[int]] = None,
        activation_type: str = "SiLU",
        dropout: float = 0.0,
        attention_weights: T.Optional[str] = AttentionTypes.NATTEN,
    ):
        super().__init__()
        dilations = list(dilations) if dilations is not None else [1, 2]
        common = dict(
            activation_type=activation_type,
            natten_attn_drop=dropout,
            natten_proj_drop=dropout,
        )
        self.over_d = UNetUpBlock(
            channels[3],
            up_channels,
            kernel_size=1,
            dilations=[1],
            resample_up=False,
            attention_weights=None,
            **common,
        )
        for name, level, dils in (
            ("up_cu", "c", dilations[:2]),
            ("up_bu", "b", dilations[:3]),
            ("up_au", "a", dilations),
        ):
            self.add_module(
                name,
                UNetUpBlock(
                    up_channels,
                    up_channels,
                    dilations=dils,
                    attention_weights=attention_weights,
                    **{**common, **NATTEN_PARAMS[level]},
                ),
            )

    def forward(self, x: T.Dict[str, Tensor]) -> T.Dict[str, Tensor]:
        x_du = self.over_d(x["x_d"], size=x["x_d"].shape[-2:])
        x_cu = self.up_cu(x_du, size=x["x_c"].shape[-2:])
        x_bu = self.up_bu(x_cu, size=x["x_b"].shape[-2:])
        x_au = self.up_au(x_bu, size=x["x_a"].shape[-2:])
        return {"x_au": x_au, "x_bu": x_bu, "x_cu": x_cu, "x_du": x_du}


class TowerUNetBlock(nn.Module):
    """One UNet3+-style full-scale fusion tower (no attention), output at
    ``up_channels``."""

    def __init__(
        self,
        backbone_side_channels: int,
        backbone_down_channels: int,
        up_channels: int,
        tower: bool = False,
        dilations: T.Optional[T.Sequence[int]] = None,
        activation_type: str = "SiLU",
    ):
        super().__init__()
        self.backbone_down_conv = ConvTranspose2d(
            backbone_down_channels, backbone_down_channels
        )
        self.decode_down_conv = ConvTranspose2d(up_channels, up_channels)
        self.tower_conv = (
            ConvTranspose2d(up_channels, up_channels) if tower else None
        )
        cat_channels = (
            backbone_side_channels
            + backbone_down_channels
            + up_channels * (2 + int(tower))
        )
        self.res_conv = ResidualAConv(
            cat_channels,
            up_channels,
            dilations=dilations,
            activation_type=activation_type,
        )

    def forward(
        self,
        backbone_side: Tensor,
        backbone_down: Tensor,
        decode_side: Tensor,
        decode_down: Tensor,
        tower_down: T.Optional[Tensor] = None,
    ) -> Tensor:
        size = decode_side.shape[-2:]
        parts = [
            backbone_side,
            self.backbone_down_conv(backbone_down, size),
            decode_side,
            self.decode_down_conv(decode_down, size),
        ]
        if self.tower_conv is not None:
            parts.append(self.tower_conv(tower_down, size))
        return self.res_conv(torch.cat(parts, dim=1))


class TowerUNetFusion(nn.Module):
    """Three cascaded fusion towers c -> b -> a."""

    def __init__(
        self,
        channels: T.Sequence[int],
        up_channels: int,
        dilations: T.Optional[T.Sequence[int]] = None,
        activation_type: str = "SiLU",
    ):
        super().__init__()
        dilations = list(dilations) if dilations is not None else [1, 2]
        common = dict(up_channels=up_channels, activation_type=activation_type)
        self.tower_c = TowerUNetBlock(
            channels[2], channels[3], dilations=dilations[:2], **common
        )
        self.tower_b = TowerUNetBlock(
            channels[1], channels[2], tower=True, dilations=dilations, **common
        )
        self.tower_a = TowerUNetBlock(
            channels[0], channels[1], tower=True, dilations=dilations, **common
        )

    def forward(
        self,
        encoded: T.Dict[str, Tensor],
        decoded: T.Dict[str, Tensor],
    ) -> T.Dict[str, Tensor]:
        x_tower_c = self.tower_c(
            encoded["x_c"],
            encoded["x_d"],
            decoded["x_cu"],
            decoded["x_du"],
        )
        x_tower_b = self.tower_b(
            encoded["x_b"],
            encoded["x_c"],
            decoded["x_bu"],
            decoded["x_cu"],
            tower_down=x_tower_c,
        )
        x_tower_a = self.tower_a(
            encoded["x_a"],
            encoded["x_b"],
            decoded["x_au"],
            decoded["x_bu"],
            tower_down=x_tower_b,
        )
        return {
            "x_tower_a": x_tower_a,
            "x_tower_b": x_tower_b,
            "x_tower_c": x_tower_c,
        }
