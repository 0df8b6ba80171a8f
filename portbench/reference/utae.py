"""The plain fp32 reference of U-TAE (the ``utae-pastis`` configuration):
a frozen copy of the published model's math (github.com/VSainteuf/
utae-paps ``src/backbones/utae.py``, ``ltae.py``), its loss and Adam, in
plain PyTorch. It imports nothing of the program under test or of JAX;
the benchmark's train driver runs it with TF32 off.

Departures from the published code, each one of the program's inputs: the
pad mask (B, T) is passed in (the published model finds pads as images
equal to the pad value; z-scored inputs padded with zeros give the same);
dropout draws from the generator in scope (``dropout.py``), so that the
reference replays the program's masks. The encoder computes only the real
dates of each chip (``smart_forward``), as published; without a mask,
every date (the published path when nothing is padded), which is how the
operation counts (``roofline_utae.py``) run it on the meta device.

``UTAETrainer`` is the train step of ``train_semantic.py``: the model in
training mode, cross-entropy with the last class weighing 0, Adam (0.9,
0.999) at a constant learning rate, no weight decay and no clip; it keeps
the first step's gradients. ``compute`` wraps the forward and backward
(the fp8 control, ``lowp.py``).
"""

import contextlib
import math
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Dropout, dropout_rng

Tensor = torch.Tensor


class ConvLayer(nn.Module):
    def __init__(self, nkernels, norm="batch", k=3, s=1, p=1, n_groups=4, last_relu=True,
                 padding_mode="reflect"):
        super().__init__()
        layers = []
        for i in range(len(nkernels) - 1):
            layers.append(nn.Conv2d(nkernels[i], nkernels[i + 1], kernel_size=k, padding=p,
                                    stride=s, padding_mode=padding_mode))
            if norm == "batch":
                layers.append(nn.BatchNorm2d(nkernels[i + 1]))
            else:
                layers.append(nn.GroupNorm(num_channels=nkernels[i + 1], num_groups=n_groups))
            if last_relu or i < len(nkernels) - 2:
                layers.append(nn.ReLU())
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return self.conv(x)


class TemporallySharedBlock(nn.Module):
    def smart_forward(self, x: Tensor, pad_mask: T.Optional[Tensor]) -> Tensor:
        """The block over the real dates of (B, T, C, H, W) alone; pad
        dates' outputs are 0. Without a mask, over every date."""
        b, t = x.shape[:2]
        flat = x.reshape(b * t, *x.shape[2:])
        if pad_mask is None:
            out = self.forward(flat)
            return out.view(b, t, *out.shape[1:])
        real = ~pad_mask.reshape(-1)
        computed = self.forward(flat[real])
        out = torch.zeros((b * t, *computed.shape[1:]), dtype=computed.dtype, device=x.device)
        out[real] = computed
        return out.view(b, t, *out.shape[1:])


class ConvBlock(TemporallySharedBlock):
    def __init__(self, nkernels, norm="batch", padding_mode="reflect"):
        super().__init__()
        self.conv = ConvLayer(nkernels, norm=norm, padding_mode=padding_mode)

    def forward(self, x):
        return self.conv(x)


class DownConvBlock(TemporallySharedBlock):
    def __init__(self, d_in, d_out, k, s, p, norm="batch", padding_mode="reflect"):
        super().__init__()
        self.down = ConvLayer([d_in, d_in], norm=norm, k=k, s=s, p=p, padding_mode=padding_mode)
        self.conv1 = ConvLayer([d_in, d_out], norm=norm, padding_mode=padding_mode)
        self.conv2 = ConvLayer([d_out, d_out], norm=norm, padding_mode=padding_mode)

    def forward(self, x):
        out = self.down(x)
        out = self.conv1(out)
        return out + self.conv2(out)


class UpConvBlock(nn.Module):
    def __init__(self, d_in, d_out, k, s, p, d_skip, padding_mode="reflect"):
        super().__init__()
        self.skip_conv = nn.Sequential(
            nn.Conv2d(d_skip, d_skip, 1), nn.BatchNorm2d(d_skip), nn.ReLU()
        )
        self.up = nn.Sequential(
            nn.ConvTranspose2d(d_in, d_out, k, s, p), nn.BatchNorm2d(d_out), nn.ReLU()
        )
        self.conv1 = ConvLayer([d_out + d_skip, d_out], padding_mode=padding_mode)
        self.conv2 = ConvLayer([d_out, d_out], padding_mode=padding_mode)

    def forward(self, x, skip):
        out = torch.cat([self.up(x), self.skip_conv(skip)], dim=1)
        out = self.conv1(out)
        return out + self.conv2(out)


class PositionalEncoder(nn.Module):
    def __init__(self, d, T=1000, repeat=None):
        super().__init__()
        self.repeat = repeat
        # A buffer (the published module keeps an attribute), so that the
        # model's dtype carries to it.
        self.register_buffer("denom", torch.pow(T, 2 * (torch.arange(d).float() // 2) / d),
                             persistent=False)

    def forward(self, positions):
        table = positions[:, :, None].to(self.denom.dtype) / self.denom[None, None, :]
        table[:, :, 0::2] = torch.sin(table[:, :, 0::2])
        table[:, :, 1::2] = torch.cos(table[:, :, 1::2])
        return torch.cat([table for _ in range(self.repeat)], dim=-1)


class ScaledDotProductAttention(nn.Module):
    def __init__(self, temperature, attn_dropout=0.1):
        super().__init__()
        self.temperature = temperature
        self.dropout = Dropout(attn_dropout)

    def forward(self, q, k, v, pad_mask):
        attn = torch.matmul(q.unsqueeze(1), k.transpose(1, 2)) / self.temperature
        if pad_mask is not None:
            attn = attn.masked_fill(pad_mask.unsqueeze(1), -1e3)
        attn = self.dropout(torch.softmax(attn, dim=2))
        return torch.matmul(attn, v), attn


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head, d_k, d_in):
        super().__init__()
        self.n_head, self.d_k, self.d_in = n_head, d_k, d_in
        self.Q = nn.Parameter(torch.zeros((n_head, d_k)))
        self.fc1_k = nn.Linear(d_in, n_head * d_k)
        self.attention = ScaledDotProductAttention(temperature=math.sqrt(d_k))

    def forward(self, v, pad_mask):
        d_k, n_head = self.d_k, self.n_head
        sz_b, seq_len, _ = v.size()
        q = torch.stack([self.Q for _ in range(sz_b)], dim=1).view(-1, d_k)
        k = self.fc1_k(v).view(sz_b, seq_len, n_head, d_k)
        k = k.permute(2, 0, 1, 3).contiguous().view(-1, seq_len, d_k)
        if pad_mask is not None:
            pad_mask = pad_mask.repeat((n_head, 1))
        v = torch.stack(v.split(v.shape[-1] // n_head, dim=-1)).view(n_head * sz_b, seq_len, -1)
        output, attn = self.attention(q, k, v, pad_mask)
        attn = attn.view(n_head, sz_b, 1, seq_len).squeeze(dim=2)
        output = output.view(n_head, sz_b, 1, self.d_in // n_head).squeeze(dim=2)
        return output, attn


class LTAE2d(nn.Module):
    def __init__(self, in_channels=128, n_head=16, d_k=4, mlp=(256, 128), dropout=0.2,
                 d_model=256, T=1000):
        super().__init__()
        self.n_head = n_head
        self.inconv = nn.Conv1d(in_channels, d_model, 1)
        self.positional_encoder = PositionalEncoder(d_model // n_head, T=T, repeat=n_head)
        self.attention_heads = MultiHeadAttention(n_head=n_head, d_k=d_k, d_in=d_model)
        self.in_norm = nn.GroupNorm(num_groups=n_head, num_channels=in_channels)
        self.out_norm = nn.GroupNorm(num_groups=n_head, num_channels=mlp[-1])
        self.mlp = nn.Sequential(nn.Linear(mlp[0], mlp[1]), nn.BatchNorm1d(mlp[1]), nn.ReLU())
        self.dropout = Dropout(dropout)

    def forward(self, x, batch_positions, pad_mask):
        sz_b, seq_len, d, h, w = x.shape
        if pad_mask is not None:
            pad_mask = pad_mask.unsqueeze(-1).repeat((1, 1, h)).unsqueeze(-1).repeat((1, 1, 1, w))
            pad_mask = pad_mask.permute(0, 2, 3, 1).contiguous().view(sz_b * h * w, seq_len)
        out = x.permute(0, 3, 4, 1, 2).contiguous().view(sz_b * h * w, seq_len, d)
        out = self.in_norm(out.permute(0, 2, 1)).permute(0, 2, 1)
        out = self.inconv(out.permute(0, 2, 1)).permute(0, 2, 1)
        bp = batch_positions.unsqueeze(-1).repeat((1, 1, h)).unsqueeze(-1).repeat((1, 1, 1, w))
        bp = bp.permute(0, 2, 3, 1).contiguous().view(sz_b * h * w, seq_len)
        out = out + self.positional_encoder(bp)
        out, attn = self.attention_heads(out, pad_mask)
        out = out.permute(1, 0, 2).contiguous().view(sz_b * h * w, -1)
        out = self.out_norm(self.dropout(self.mlp(out)))
        out = out.view(sz_b, h, w, -1).permute(0, 3, 1, 2)
        attn = attn.view(self.n_head, sz_b, h, w, seq_len).permute(0, 1, 4, 2, 3)
        return out, attn


def temporal_aggregate(x, pad_mask, attn_mask):
    """``Temporal_Aggregator(mode="att_group")``: x (B, T, C, H, W)."""
    n_heads, b, t, h, w = attn_mask.shape
    attn = attn_mask.view(n_heads * b, t, h, w)
    if x.shape[-2] > w:
        attn = nn.Upsample(size=x.shape[-2:], mode="bilinear", align_corners=False)(attn)
    else:
        attn = nn.AvgPool2d(kernel_size=w // x.shape[-2])(attn)
    attn = attn.view(n_heads, b, t, *x.shape[-2:])
    if pad_mask is not None:
        attn = attn * (~pad_mask).to(attn.dtype)[None, :, :, None, None]
    out = torch.stack(x.chunk(n_heads, dim=2))
    out = (attn[:, :, :, None, :, :] * out).sum(dim=2)
    return torch.cat([group for group in out], dim=1)


class UTAE(nn.Module):
    def __init__(self, input_dim=10, encoder_widths=(64, 64, 64, 128),
                 decoder_widths=(32, 32, 64, 128), out_conv=(32, 20), str_conv_k=4,
                 str_conv_s=2, str_conv_p=1, encoder_norm="group", n_head=16, d_model=256,
                 d_k=4, padding_mode="reflect"):
        super().__init__()
        self.n_stages = len(encoder_widths)
        self.in_conv = ConvBlock([input_dim, encoder_widths[0], encoder_widths[0]],
                                 norm=encoder_norm, padding_mode=padding_mode)
        self.down_blocks = nn.ModuleList(
            DownConvBlock(encoder_widths[i], encoder_widths[i + 1], str_conv_k, str_conv_s,
                          str_conv_p, norm=encoder_norm, padding_mode=padding_mode)
            for i in range(self.n_stages - 1)
        )
        self.up_blocks = nn.ModuleList(
            UpConvBlock(decoder_widths[i], decoder_widths[i - 1], str_conv_k, str_conv_s,
                        str_conv_p, d_skip=encoder_widths[i - 1], padding_mode=padding_mode)
            for i in range(self.n_stages - 1, 0, -1)
        )
        self.temporal_encoder = LTAE2d(encoder_widths[-1], n_head=n_head, d_k=d_k,
                                       mlp=(d_model, encoder_widths[-1]), d_model=d_model)
        self.out_conv = ConvBlock([decoder_widths[0], *out_conv], padding_mode=padding_mode)

    def forward(self, x, batch_positions, pad_mask, return_att=False):
        """x (B, T, C, H, W), batch_positions (B, T) days, pad_mask (B, T)
        True at pad dates (None: every date real) -> logits (B, K, H,
        W)."""
        out = self.in_conv.smart_forward(x, pad_mask)
        feature_maps = [out]
        for i in range(self.n_stages - 1):
            out = self.down_blocks[i].smart_forward(feature_maps[-1], pad_mask)
            feature_maps.append(out)
        out, att = self.temporal_encoder(feature_maps[-1], batch_positions, pad_mask)
        for i in range(self.n_stages - 1):
            skip = temporal_aggregate(feature_maps[-(i + 2)], pad_mask, att)
            out = self.up_blocks[i](out, skip)
        out = self.out_conv(out)
        return (out, att) if return_att else out


def loss(logits: Tensor, y: Tensor) -> Tensor:
    """``train_semantic.py``'s loss: cross-entropy, every class weighing 1
    but the last (``ignore_index`` -1), which weighs 0."""
    weights = torch.ones(logits.shape[1], dtype=logits.dtype, device=logits.device)
    weights[-1] = 0
    return F.cross_entropy(logits, y.long(), weight=weights)


class UTAETrainer:
    def __init__(self, model: nn.Module, learning_rate: float, eps: float,
                 compute: T.Optional[T.Callable[[nn.Module], T.ContextManager]] = None):
        self.model = model
        self.lr, self.eps = learning_rate, eps
        self.compute = compute or (lambda model: contextlib.nullcontext())
        self.params = dict(model.named_parameters())
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.t = 0
        self.first_grads: T.Optional[T.Dict[str, Tensor]] = None

    def step(self, x: Tensor, days: Tensor, pad_mask: Tensor, y: Tensor,
             generator: torch.Generator) -> float:
        """One step on x (B, T, C, H, W) fp32; returns the loss."""
        self.model.train()
        for p in self.params.values():
            p.grad = None
        with self.compute(self.model):
            with dropout_rng(generator):
                logits = self.model(x, days, pad_mask)
            value = loss(logits.float(), y)
            value.backward()
        with torch.no_grad():
            grads = {
                n: torch.zeros_like(p) if p.grad is None else p.grad
                for n, p in self.params.items()
            }
            if self.first_grads is None:
                self.first_grads = {n: g.clone() for n, g in grads.items()}
            b1, b2 = 0.9, 0.999
            self.t += 1
            for n, p in self.params.items():
                g, m, v = grads[n], self.m[n], self.v[n]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v.sqrt() / math.sqrt(1 - b2**self.t) + self.eps
                p.addcdiv_(m, denom, value=-self.lr / (1 - b1**self.t))
        return float(value.detach())
