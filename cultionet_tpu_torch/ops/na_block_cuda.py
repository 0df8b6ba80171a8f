"""The hand-written Hopper kernel of the fused NA block.

``csrc/na_block_fwd.cu`` replaces the TPU kernel
``cultionet_tpu/ops/natten_pallas.py::_na_block_kernel``; its plain PyTorch
version is ``ops/na_block.py::na_block_plain``. Build: ``ops/build.py``
compiles it for ``sm_90a`` with ``nvcc`` at first use.

``LAUNCHES["na_block_fwd"]`` counts the wrapper calls that launch it (one
per call; the kernel's two launches inside count as one).
"""

import ctypes
import typing as T

import torch

from . import build
from .na_block import LN_EPS, check_block
from .natten import check_spatial

Tensor = torch.Tensor

LAUNCHES: T.Dict[str, int] = {"na_block_fwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
build.register(
    build.Library(
        name="na_block_fwd",
        source="na_block_fwd.cu",
        headers=("na2d_common.cuh",),
        signatures={
            # dtype, x, 8 parameters, qkv scratch, out,
            # B, H, W, C, Cp, heads, kernel_size, dilation, eps
            "na_block_fwd": [
                _INT, *[_PTR] * 11, *[_INT] * 8, _FLOAT,
            ],
        },
        error_string="na_block_error_string",
    )
)


def padded_channels(channels: int) -> int:
    """The kernel's channel count: C rounded up to the WMMA depth 16."""
    return -(-channels // 16) * 16


def _kernel_weights(
    params: T.Mapping[str, Tensor], channels: int, device
) -> T.Dict[str, Tensor]:
    """The parameters as the kernel takes them, as ``_na_block_pallas_d1``
    casts them: weights in bf16, LayerNorm vectors and biases in fp32; the
    weights and ``b_qkv`` zero-padded to Cp channels (q, k, v each in a
    column group of Cp)."""
    c, cp = channels, padded_channels(channels)
    f32 = {
        key: params[key].to(device=device, dtype=torch.float32).contiguous()
        for key in ("ln1_scale", "ln1_bias", "b_proj", "ln2_scale", "ln2_bias")
    }
    w_qkv = params["w_qkv"].to(device=device, dtype=torch.bfloat16)
    b_qkv = params["b_qkv"].to(device=device, dtype=torch.float32)
    w_proj = params["w_proj"].to(device=device, dtype=torch.bfloat16)
    if cp != c:
        padded = torch.zeros((cp, 3 * cp), dtype=torch.bfloat16, device=device)
        bias = torch.zeros(3 * cp, dtype=torch.float32, device=device)
        for g in range(3):
            padded[:c, g * cp : g * cp + c] = w_qkv[:, g * c : (g + 1) * c]
            bias[g * cp : g * cp + c] = b_qkv[g * c : (g + 1) * c]
        w_qkv, b_qkv = padded, bias
        proj = torch.zeros((cp, cp), dtype=torch.bfloat16, device=device)
        proj[:c, :c] = w_proj
        w_proj = proj
    return {
        **f32,
        "w_qkv": w_qkv.contiguous(),
        "b_qkv": b_qkv.contiguous(),
        "w_proj": w_proj.contiguous(),
    }


def launch_na_block_fwd(
    x: Tensor,
    params: T.Mapping[str, Tensor],
    num_heads: int,
    kernel_size: int,
    dilation: int = 1,
) -> Tensor:
    """Launch ``na_block_fwd`` on the current stream: the fused block's
    forward for a CUDA ``x`` (B, H, W, C) in fp32 or bf16, kernel_size 1 or
    3, any dilation (windows clamped within each coset), C up to 512;
    returns a new contiguous tensor in x's dtype. Anything else raises."""
    if x.device.type != "cuda":
        raise ValueError(
            f"na_block_fwd: x must lie on a CUDA device, got {x.device}"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(
            f"na_block_fwd: x has dtype {x.dtype}; the kernel takes "
            f"{sorted(map(str, _DTYPES))}"
        )
    check_block(x, params, num_heads)
    if kernel_size not in (1, 3):
        raise ValueError(
            f"na_block_fwd: kernel_size must be 1 or 3, got {kernel_size}"
        )
    batch, height, width, channels = x.shape
    check_spatial(height, width, kernel_size, dilation)
    cp = padded_channels(channels)
    weights = _kernel_weights(params, channels, x.device)
    x = x.contiguous()
    out = torch.empty_like(x)
    scratch = torch.empty(
        (batch * height * width, 3 * cp), dtype=torch.float32, device=x.device
    )
    build.launch(
        "na_block_fwd", "na_block_fwd", x.device,
        _DTYPES[x.dtype], x.data_ptr(),
        weights["ln1_scale"].data_ptr(), weights["ln1_bias"].data_ptr(),
        weights["w_qkv"].data_ptr(), weights["b_qkv"].data_ptr(),
        weights["w_proj"].data_ptr(), weights["b_proj"].data_ptr(),
        weights["ln2_scale"].data_ptr(), weights["ln2_bias"].data_ptr(),
        scratch.data_ptr(), out.data_ptr(),
        batch, height, width, channels, cp, num_heads, kernel_size, dilation,
        LN_EPS,
    )
    LAUNCHES["na_block_fwd"] += 1
    return out
