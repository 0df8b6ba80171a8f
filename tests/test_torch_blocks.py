"""Each ported block against its JAX module, fp32 on the CPU, with the JAX
weights moved over by cultionet_tpu_torch/utils/params.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cultionet_tpu.models import temporal as jax_temporal
from cultionet_tpu.nn import attention as jax_attention
from cultionet_tpu.nn import blocks as jax_blocks
from cultionet_tpu_torch.models import temporal as torch_temporal
from cultionet_tpu_torch.nn import attention as torch_attention
from cultionet_tpu_torch.nn import blocks as torch_blocks
from cultionet_tpu_torch.utils.params import load_flax

from torch_port_helpers import seeded_variables

ATOL = 1e-5


def _nhwc(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype("float32")


def _run_pair(jax_module, torch_module, x_nhwc, *args, nchw=True, **kw):
    """Init the JAX module, translate its (perturbed) variables into the
    torch module, and return both outputs as NHWC numpy arrays."""
    xj = jnp.asarray(x_nhwc)
    variables = seeded_variables(jax_module, xj, *args, **kw)
    want = jax_module.apply(variables, xj, *args, **kw)
    load_flax(torch_module, variables).eval()
    xt = torch.from_numpy(x_nhwc)
    if nchw:
        xt = xt.permute(0, 3, 1, 2)
    with torch.no_grad():
        got = torch_module(xt, *args)
    if nchw:
        got = got.permute(0, 2, 3, 1)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize(
    "in_hw,size,stride",
    [((6, 5), (12, 10), 2), ((5, 5), (9, 9), 2), ((3, 4), (11, 15), 4)],
)
def test_conv_transpose_with_resize(in_hw, size, stride):
    x = _nhwc(0, (2, *in_hw, 6))
    got, want = _run_pair(
        jax_blocks.ConvTranspose2d(out_channels=5, stride=stride),
        torch_blocks.ConvTranspose2d(6, 5, stride=stride),
        x,
        size,
    )
    assert got.shape == (2, *size, 5)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize(
    "kernel,padding,dilation,stride,act",
    [(3, 1, 1, 1, True), (3, 2, 2, 1, True), (3, 1, 1, 2, False), (1, 0, 1, 1, True)],
)
def test_conv_block(kernel, padding, dilation, stride, act):
    x = _nhwc(1, (2, 9, 10, 4))
    got, want = _run_pair(
        jax_blocks.ConvBlock2d(
            out_channels=6,
            kernel_size=kernel,
            padding=padding,
            dilation=dilation,
            stride=stride,
            add_activation=act,
        ),
        torch_blocks.ConvBlock2d(
            4, 6, kernel, padding=padding, dilation=dilation, stride=stride,
            add_activation=act,
        ),
        x,
    )
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("in_channels", [8, 5])
@pytest.mark.parametrize("natten_dilation", [1, 2])
def test_residual_a_conv_natten(in_channels, natten_dilation):
    x = _nhwc(2, (2, 12, 11, in_channels))
    natten = dict(
        natten_num_heads=2, natten_kernel_size=3, natten_dilation=natten_dilation
    )
    got, want = _run_pair(
        jax_blocks.ResidualAConv(
            out_channels=8, dilations=[1, 2], attention_weights="natten", **natten
        ),
        torch_blocks.ResidualAConv(
            in_channels, 8, dilations=[1, 2], attention_weights="natten", **natten
        ),
        x,
    )
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("pool_first", [True, False])
def test_pool_residual_conv(pool_first):
    x = _nhwc(3, (2, 11, 12, 4))
    kw = dict(dilations=[1, 2], pool_first=pool_first, dropout=0.2)
    got, want = _run_pair(
        jax_blocks.PoolResidualConv(out_channels=8, **kw),
        torch_blocks.PoolResidualConv(4, 8, **kw),
        x,
    )
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("heads,kernel,dilation", [(2, 3, 1), (4, 3, 2), (1, 5, 1)])
def test_neighborhood_attention_module(heads, kernel, dilation):
    x = _nhwc(4, (2, 10, 11, 8))
    kw = dict(num_heads=heads, kernel_size=kernel, dilation=dilation)
    got, want = _run_pair(
        jax_attention.NeighborhoodAttention2D(**kw),
        torch_attention.NeighborhoodAttention2D(8, **kw),
        x,
        nchw=False,
    )
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("in_time", [5, 6])
def test_pre_time_reduction(in_time):
    x = np.random.default_rng(5).random((2, in_time, 7, 6, 3)).astype("float32")
    xj = jnp.asarray(x)
    jm = jax_temporal.PreTimeReduction(out_channels=8, in_time=in_time)
    variables = seeded_variables(jm, xj)
    want = np.asarray(jm.apply(variables, xj))
    tm = load_flax(
        torch_temporal.PreTimeReduction(3, 8, in_time), variables
    ).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
