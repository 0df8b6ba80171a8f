"""The port's fused NA block (``cultionet_tpu_torch/ops/na_block.py``)
against the JAX block (``cultionet_tpu/ops/natten_pallas.py``) on the CPU.

Tolerances:
- ``na_block_reference`` vs the JAX reference, fp32: 1e-5 (the same fp32
  composition, sums in another order).
- ``na_block`` (on the CPU the plain version of the kernel's function) vs
  ``na_block_pallas(..., interpret=True)``: atol 2e-3, rtol 0. Measured
  over these shapes and three seeds: at most 1.2e-6, except where a value
  rounds to the neighbouring bf16 number (one step is 2^-8 of it) after
  fp32 sums in another order, and the step passes through the projection
  and LayerNorm: 6.9e-4 once (0.26% of that case's outputs above 1e-4).
  The JAX test's own limit against the fp32 reference is atol 0.06 / rtol
  0.05.
- ``fused_na_block`` gradients vs the JAX ``fused_na_block`` vjp, fp32:
  atol 1e-5 and rtol 1e-5, the JAX test's own limits; both differentiate
  the fp32 reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cultionet_tpu.ops import natten_pallas as jax_block
from cultionet_tpu_torch.ops import na_block as port
from cultionet_tpu_torch.ops.na_block_cuda import (
    head_layout,
    launch_na_block_fwd,
    padded_channels,
    prepare_weights,
    unpack_weights,
)
from cultionet_tpu_torch.utils.params import na_block_params

# (x shape, heads, kernel_size, dilation)
CASES = [
    ((2, 12, 12, 8), 2, 3, 1),
    ((2, 16, 12, 16), 4, 3, 1),
    ((2, 12, 16, 8), 2, 3, 2),  # the JAX test's dilated case
    ((2, 12, 12, 8), 2, 5, 1),  # k > 3: the reference path
    ((2, 13, 14, 8), 2, 3, 2),  # ragged cosets: the reference path
    ((1, 10, 9, 24), 3, 1, 1),  # k = 1, C not a multiple of 16
]


def make_params(rng, channels):
    """The JAX test's parameter draws (tests/test_natten_pallas.py)."""
    return {
        "ln1_scale": rng.normal(1.0, 0.1, size=(channels,)),
        "ln1_bias": rng.normal(0.0, 0.1, size=(channels,)),
        "w_qkv": rng.normal(0.0, 0.2, size=(channels, 3 * channels)),
        "b_qkv": rng.normal(0.0, 0.1, size=(3 * channels,)),
        "w_proj": rng.normal(0.0, 0.2, size=(channels, channels)),
        "b_proj": rng.normal(0.0, 0.1, size=(channels,)),
        "ln2_scale": rng.normal(1.0, 0.1, size=(channels,)),
        "ln2_bias": rng.normal(0.0, 0.1, size=(channels,)),
    }


def inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype("float32")
    arrays = {
        k: v.astype("float32") for k, v in make_params(rng, shape[-1]).items()
    }
    jax_params = {k: jnp.asarray(v) for k, v in arrays.items()}
    return x, arrays, jax_params


@pytest.mark.parametrize("shape,heads,ks,dil", CASES)
def test_reference_matches_jax(shape, heads, ks, dil):
    x, arrays, jax_params = inputs(shape)
    want = jax_block.na_block_reference(
        jnp.asarray(x), jax_params, heads, ks, dil
    )
    got = port.na_block_reference(
        torch.from_numpy(x), na_block_params(arrays, "cpu"), heads, ks, dil
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape,heads,ks,dil", CASES)
def test_na_block_matches_pallas_interpret(shape, heads, ks, dil):
    x, arrays, jax_params = inputs(shape)
    want = jax_block.na_block_pallas(
        jnp.asarray(x), jax_params, heads, ks, dil, interpret=True
    )
    params = na_block_params(arrays, "cpu")
    got = port.na_block(torch.from_numpy(x), params, heads, ks, dil)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
    if port.takes_reference_path(shape[1], shape[2], ks, dil):
        # The JAX function's own dispatch: these are exactly the reference.
        want_ref = port.na_block_reference(
            torch.from_numpy(x), params, heads, ks, dil
        )
        assert torch.equal(got, want_ref)
    else:
        assert torch.equal(
            got, port.na_block_plain(torch.from_numpy(x), params, heads, ks, dil)
        )


def test_plain_bf16_input_keeps_dtype():
    x, arrays, _ = inputs((1, 8, 8, 16))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    params = na_block_params(arrays, "cpu")
    got = port.na_block(xb, params, 4, 3)
    assert got.dtype == torch.bfloat16
    # The kernel's function rounds its operands to bf16 anyway, so a bf16 x
    # changes only LN1's input.
    want = port.na_block_plain(xb.float(), params, 4, 3)
    assert float((got.float() - want).abs().max()) <= 2e-2


@pytest.mark.parametrize(
    "shape,heads,ks,dil",
    [((1, 8, 8, 8), 2, 3, 1), ((2, 12, 16, 8), 2, 3, 2), CASES[3]],
)
def test_fused_gradients_match_jax(shape, heads, ks, dil):
    x, arrays, jax_params = inputs(shape, seed=1)
    g = np.random.default_rng(2).normal(size=shape).astype("float32")
    _, vjp = jax.vjp(
        lambda x_, p_: jax_block.fused_na_block(x_, p_, heads, ks, dil, True),
        jnp.asarray(x),
        jax_params,
    )
    want_x, want_p = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    params = {
        k: v.requires_grad_() for k, v in na_block_params(arrays, "cpu").items()
    }
    out = port.fused_na_block(xt, params, heads, ks, dil)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(
        xt.grad.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-5
    )
    for key in port.PARAM_KEYS:
        np.testing.assert_allclose(
            params[key].grad.numpy(),
            np.asarray(want_p[key]),
            rtol=1e-5,
            atol=1e-5,
            err_msg=key,
        )


def test_na_block_params_round_trip_and_names_bad_keys():
    _, arrays, _ = inputs((1, 4, 4, 8))
    params = na_block_params(arrays, "cpu", torch.float64)
    assert list(params) == list(port.PARAM_KEYS)
    for key, value in arrays.items():
        assert params[key].dtype == torch.float64
        np.testing.assert_array_equal(params[key].numpy(), value)
    missing = dict(arrays)
    del missing["b_qkv"]
    with pytest.raises(ValueError, match="b_qkv"):
        na_block_params(missing, "cpu")
    with pytest.raises(ValueError, match="w_extra"):
        na_block_params({**arrays, "w_extra": arrays["b_proj"]}, "cpu")


def test_kernel_weight_padding_keeps_the_products():
    """The wrapper lays C = 24 out for the kernel: 32 input channels, each
    head padded to 16 columns, heads grouped into passes, rows padded to
    the copies' widths; the laid-out weights give the same q, k, v and
    projection on the real channels and zeros on the padding (3 heads: one
    pass of 3; 6 heads: two passes of 3)."""
    x, arrays, _ = inputs((1, 5, 5, 24))
    params = na_block_params(arrays, "cpu")
    h = torch.from_numpy(x).reshape(-1, 24)
    want = (
        h.to(torch.bfloat16).float() @ params["w_qkv"].to(torch.bfloat16).float()
        + params["b_qkv"]
    )
    h_pad = torch.nn.functional.pad(h, (0, 8)).to(torch.bfloat16).float()
    for heads, passes in ((3, 1), (6, 2)):
        d = 24 // heads
        weights = prepare_weights(params, heads, "cpu")
        assert padded_channels(24) == 32
        assert head_layout(24, heads) == (16, 3, passes)
        assert weights["w_qkv"].shape == (passes, 1, 32, 200)
        assert weights["w_qkv"].dtype == torch.bfloat16
        assert not weights["w_qkv"][..., 144:].any()
        assert weights["b_qkv"].shape == (passes, 144)
        w_qkv, proj = unpack_weights(weights, 24, heads)
        for ps in range(passes):
            got = h_pad @ w_qkv[ps].float() + weights["b_qkv"][ps]
            for part in range(3):
                for g in range(3):
                    n = ps * 3 + g
                    col = part * 48 + g * 16
                    torch.testing.assert_close(
                        got[:, col : col + d],
                        want[:, part * 24 + n * d : part * 24 + (n + 1) * d],
                    )
                    assert not got[:, col + d : col + 16].any()
        assert weights["w_proj"].shape == (1, heads * 16, 264)
        assert not weights["w_proj"][..., 24:].any()
        proj = proj.float()
        assert proj.shape == (heads * 16, 32)
        w_proj = params["w_proj"].to(torch.bfloat16).float()
        for n in range(heads):
            assert torch.equal(
                proj[n * 16 : n * 16 + d, :24], w_proj[n * d : (n + 1) * d]
            )
            assert not proj[n * 16 + d : (n + 1) * 16].any()
        assert not proj[:, 24:].any()


def test_wrapper_and_block_refuse_bad_input():
    x, arrays, _ = inputs((1, 8, 8, 8))
    params = na_block_params(arrays, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        launch_na_block_fwd(torch.from_numpy(x), params, 2, 3)
    with pytest.raises(ValueError, match="heads"):
        port.na_block(torch.from_numpy(x), params, 3, 3)
    with pytest.raises(ValueError, match="Spatial"):
        port.na_block(torch.from_numpy(x), params, 2, 3, dilation=3)
    with pytest.raises(ValueError, match="w_proj"):
        port.na_block(
            torch.from_numpy(x), {**params, "w_proj": params["w_qkv"]}, 2, 3
        )
