"""The plain fp32 reference of TSViT (the ``tsvit-pastis24``
configuration): a frozen copy of the published model's math
(github.com/michaeltrs/DeepSatModels ``models/TSViT/TSViTdense.py`` and
``module.py``), its masked cross-entropy and its optimizer, in plain
PyTorch with einsum attention. It imports nothing of the program under
test or of JAX; run it with TF32 off (``no_tf32``).

Inputs are what the published model sees after its data pipeline: x (B,
T, H, W, C) already z-scored, zero at pad dates (``CutOrPad`` pads with
zero rows after the normalization), and the day of year of each date
(``day_of_year``: 0 at pad dates). Departures from the published code:
the day of year arrives as an integer rather than as a last input
channel holding doy / 365 (the published one-hot index
``int(doy / 365 * 365.0001)`` is the day of year again); the head's p^2
outputs of each patch go back to that patch's own p x p block (the
published ``reshape(B, H, W, K)`` lays each patch's outputs along a row).

``TSViTTrainer`` is the train step: the model in training mode, the
masked cross-entropy (labels outside [0, K), PASTIS's void 19 among them,
left out of the mean), AdamW (0.9, 0.999) with decoupled weight decay
and a learning rate by step, no clip; it keeps the first step's
gradients. ``compute`` wraps the forward and backward (the fp8 control,
``lowp_train.py``).
"""

import contextlib
import math
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

DAYS = 366
FIRST_DAY_OF_YEAR = 243  # September 1, counted from 0


@contextlib.contextmanager
def no_tf32() -> T.Iterator[None]:
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def day_of_year(days: Tensor, date_count: Tensor) -> Tensor:
    """(B, T) days from September 1 -> int64 day of year, 0 at the pad
    dates (those past each chip's ``date_count``)."""
    steps = days.shape[1]
    real = torch.arange(steps, device=days.device)[None] < date_count.long()[:, None]
    return torch.where(real, (days.long() + FIRST_DAY_OF_YEAR) % 365, 0)


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class FeedForward(nn.Module):
    def __init__(self, dim, hidden_dim):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(hidden_dim, dim), nn.Dropout(0.0))

    def forward(self, x):
        return self.net(x)


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.scale = dim_head ** -0.5
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(0.0))

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        dots = torch.einsum("bhid,bhjd->bhij", q, k) * self.scale
        out = torch.einsum("bhij,bhjd->bhid", dots.softmax(dim=-1), v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class Transformer(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([PreNorm(dim, Attention(dim, heads, dim_head)),
                           PreNorm(dim, FeedForward(dim, mlp_dim))])
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return self.norm(x)


class TSViT(nn.Module):
    def __init__(self, in_channels=10, img_res=24, patch_size=2, num_classes=19, dim=128,
                 temporal_depth=4, spatial_depth=4, heads=4, dim_head=32, scale_dim=4):
        super().__init__()
        self.img_res, self.patch_size, self.num_classes, self.dim = (
            img_res, patch_size, num_classes, dim)
        self.num_patches_1d = img_res // patch_size
        self.to_patch_embedding = nn.Sequential(
            nn.Identity(), nn.Linear(in_channels * patch_size**2, dim))
        self.to_temporal_embedding_input = nn.Linear(DAYS, dim)
        self.temporal_token = nn.Parameter(torch.randn(1, num_classes, dim))
        self.temporal_transformer = Transformer(dim, temporal_depth, heads, dim_head,
                                                dim * scale_dim)
        self.space_pos_embedding = nn.Parameter(torch.randn(1, self.num_patches_1d**2, dim))
        self.space_transformer = Transformer(dim, spatial_depth, heads, dim_head,
                                             dim * scale_dim)
        self.mlp_head = nn.Sequential(nn.LayerNorm(dim), nn.Linear(dim, patch_size**2))

    def forward(self, x: Tensor, doy: Tensor) -> Tensor:
        """x (B, T, H, W, C), doy (B, T) int64 -> logits (B, K, H, W)."""
        b, t, height, width, c = x.shape
        p, k, n1 = self.patch_size, self.num_classes, self.num_patches_1d
        onehot = F.one_hot(doy, num_classes=DAYS).to(x.dtype).reshape(-1, DAYS)
        when = self.to_temporal_embedding_input(onehot).reshape(b, t, self.dim)
        # b t (h p1) (w p2) c -> (b h w) t (p1 p2 c)
        x = x.reshape(b, t, n1, p, n1, p, c).permute(0, 2, 4, 1, 3, 5, 6)
        x = self.to_patch_embedding(x.reshape(b * n1 * n1, t, p * p * c))
        x = x.reshape(b, -1, t, self.dim) + when.unsqueeze(1)
        x = x.reshape(-1, t, self.dim)
        x = torch.cat([self.temporal_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = self.temporal_transformer(x)[:, :k]
        x = x.reshape(b, n1 * n1, k, self.dim).permute(0, 2, 1, 3).reshape(b * k, n1 * n1, self.dim)
        x = self.space_transformer(x + self.space_pos_embedding)
        x = self.mlp_head(x.reshape(-1, self.dim))
        # (b k h w p1 p2) -> b k (h p1) (w p2)
        x = x.reshape(b, k, n1, n1, p, p).permute(0, 1, 2, 4, 3, 5)
        return x.reshape(b, k, height, width)


def loss(logits: Tensor, y: Tensor) -> Tensor:
    """Cross-entropy over the pixels whose label is one of the K classes
    (``masked_cross_entropy``: the void label and any other left out)."""
    y = y.long()
    real = (y >= 0) & (y < logits.shape[1])
    per_pixel = F.cross_entropy(logits, torch.where(real, y, 0), reduction="none")
    return per_pixel[real].sum() / real.sum()


def cosine_lr(learning_rate: float, steps_per_epoch: int, t_max: float = 20.0,
              eta_min: float = 1e-5) -> T.Callable[[int], float]:
    """``CosineAnnealingLR(T_max=20, eta_min=1e-5)`` stepped once an epoch."""
    def lr(step: int) -> float:
        epoch = min(step // steps_per_epoch, t_max)
        return eta_min + 0.5 * (learning_rate - eta_min) * (1 + math.cos(math.pi * epoch / t_max))
    return lr


class TSViTTrainer:
    def __init__(self, model: nn.Module, lr: T.Callable[[int], float], eps: float,
                 weight_decay: float = 0.0,
                 compute: T.Optional[T.Callable[[nn.Module], T.ContextManager]] = None):
        self.model = model
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay
        self.compute = compute or (lambda model: contextlib.nullcontext())
        self.params = dict(model.named_parameters())
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.t = 0
        self.first_grads: T.Optional[T.Dict[str, Tensor]] = None

    def step(self, x: Tensor, doy: Tensor, y: Tensor) -> float:
        """One step on x (B, T, H, W, C) fp32; returns the loss."""
        self.model.train()
        for p in self.params.values():
            p.grad = None
        with self.compute(self.model):
            value = loss(self.model(x, doy).float(), y)
            value.backward()
        with torch.no_grad():
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in self.params.items()}
            if self.first_grads is None:
                self.first_grads = {n: g.clone() for n, g in grads.items()}
            lr = self.lr(self.t)
            b1, b2 = 0.9, 0.999
            self.t += 1
            for n, p in self.params.items():
                g, m, v = grads[n], self.m[n], self.v[n]
                p.mul_(1 - lr * self.weight_decay)
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v.sqrt() / math.sqrt(1 - b2**self.t) + self.eps
                p.addcdiv_(m, denom, value=-lr / (1 - b1**self.t))
        return float(value.detach())
