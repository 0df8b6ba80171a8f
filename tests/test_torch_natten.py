"""The port's plain neighborhood attention (cultionet_tpu_torch/ops/natten.py)
against the JAX package's XLA path and gather oracle, fp32 on the CPU."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cultionet_tpu.ops import natten as jax_natten
from cultionet_tpu_torch.ops import natten as torch_natten
from cultionet_tpu_torch.ops import natten_cuda

SHAPES = [(7, 9), (13, 11)]
CASES = [
    (k, d, hw, heads)
    for k, d, hw, heads in itertools.product((1, 3, 5), (1, 2), SHAPES, (1, 4))
    if min(hw) >= k * d
]


def _qkv(hw, heads, head_dim=8, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (batch, *hw, heads, head_dim)
    return [rng.normal(size=shape).astype("float32") for _ in range(3)]


def _port(fn, qkv, k, d):
    q, kk, v = (torch.from_numpy(a) for a in qkv)
    return fn(q, kk, v, k, d).numpy()


def _jax(fn, qkv, k, d):
    return np.asarray(fn(*(jnp.asarray(a) for a in qkv), k, d))


@pytest.mark.parametrize("k,d,hw,heads", CASES)
def test_plain_matches_jax(k, d, hw, heads):
    qkv = _qkv(hw, heads)
    got = _port(torch_natten.neighborhood_attention_2d, qkv, k, d)
    np.testing.assert_allclose(
        got, _jax(jax_natten.neighborhood_attention_2d, qkv, k, d), atol=1e-5
    )
    np.testing.assert_allclose(
        got,
        _jax(jax_natten.neighborhood_attention_2d_ref, qkv, k, d),
        atol=1e-5,
    )


@pytest.mark.parametrize("k,d,hw,heads", CASES)
def test_gather_oracle_matches_jax(k, d, hw, heads):
    qkv = _qkv(hw, heads, seed=1)
    np.testing.assert_allclose(
        _port(torch_natten.neighborhood_attention_2d_ref, qkv, k, d),
        _jax(jax_natten.neighborhood_attention_2d_ref, qkv, k, d),
        atol=1e-5,
    )


@pytest.mark.parametrize("length,k,d", [(7, 3, 2), (13, 5, 2), (11, 3, 1)])
def test_axis_neighbor_indices_match_jax(length, k, d):
    np.testing.assert_array_equal(
        torch_natten._axis_neighbor_indices(length, k, d),
        jax_natten._axis_neighbor_indices(length, k, d),
    )


def test_weights_fn_hook_matches_jax():
    qkv = _qkv((9, 7), 2, seed=2)
    for k in (1, 3):
        got = torch_natten.neighborhood_attention_2d(
            *(torch.from_numpy(a) for a in qkv), k, 1,
            weights_fn=lambda w: 0.5 * w,
        ).numpy()
        want = jax_natten.neighborhood_attention_2d(
            *(jnp.asarray(a) for a in qkv), k, 1, weights_fn=lambda w: 0.5 * w
        )
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize(
    "fn",
    [
        torch_natten.neighborhood_attention_2d,
        torch_natten.neighborhood_attention_2d_ref,
        torch_natten.na2d,
    ],
)
def test_too_small_raises(fn):
    q = torch.zeros(1, 5, 9, 1, 4)
    with pytest.raises(ValueError, match="kernel_size\\*dilation"):
        fn(q, q, q, 3, 2)


def test_na2d_on_cpu_runs_the_plain_version():
    qkv = _qkv((9, 11), 4, seed=3)
    before = natten_cuda.LAUNCHES["na2d_fwd"]
    got = _port(torch_natten.na2d, qkv, 3, 2)
    assert natten_cuda.LAUNCHES["na2d_fwd"] == before
    np.testing.assert_array_equal(
        got, _port(torch_natten.neighborhood_attention_2d, qkv, 3, 2)
    )


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 9, 9, 1, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        natten_cuda.launch_na2d_fwd(q, q, q, 3, 1)


@pytest.mark.slow
def test_plain_matches_pallas_interpret():
    from cultionet_tpu.ops.natten_pallas import na2d_pallas

    qkv = _qkv((13, 11), 4, head_dim=16, seed=4)
    want = na2d_pallas(
        *(jnp.asarray(a) for a in qkv), 3, 2, interpret=True
    )
    np.testing.assert_allclose(
        _port(torch_natten.neighborhood_attention_2d, qkv, 3, 2),
        np.asarray(want),
        atol=1e-5,
    )
