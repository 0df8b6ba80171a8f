"""Gradients and attention dropout of the port's neighborhood attention
(cultionet_tpu_torch/ops/natten.py, the plain version the CUDA kernels
na2d_bwd and na2d_fwd_drop/na2d_bwd_drop are held to on the card) against
the JAX package, fp32 on the CPU, to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cultionet_tpu.ops import natten as jax_natten
from cultionet_tpu.ops.natten_pallas import na2d_fused
from cultionet_tpu_torch.nn.attention import NeighborhoodAttention2D
from cultionet_tpu_torch.nn.dropout import dropout_rng
from cultionet_tpu_torch.ops import natten as torch_natten
from cultionet_tpu_torch.ops import natten_cuda

ATOL = 1e-5


def _arrays(shape, count=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype("float32") for _ in range(count)]


def _torch_vjp(fn, q, k, v, g):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*leaves)
    grads = torch.autograd.grad(
        out, leaves, torch.from_numpy(g), materialize_grads=True
    )
    return out.detach().numpy(), [t.numpy() for t in grads]


def _jax_vjp(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize(
    "shape,dilation", [((1, 8, 8, 2, 4), 1), ((1, 10, 9, 2, 4), 2)]
)
def test_plain_grads_match_pallas_fused_interpret(shape, dilation):
    """The plain version's autograd is the oracle of na2d_bwd; the JAX
    package's own backward kernel (interpret mode) agrees with it."""
    q, k, v, g = _arrays(shape, seed=1)
    _, got = _torch_vjp(
        lambda *t: torch_natten.neighborhood_attention_2d(*t, 3, dilation),
        q, k, v, g,
    )
    _, want = _jax_vjp(
        lambda *t: na2d_fused(*t, 3, dilation, True), q, k, v, g
    )
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("k,dilation", [(3, 1), (3, 2), (5, 1), (1, 1)])
def test_explicit_mask_matches_jax_weights_fn(k, dilation):
    """Forward and VJP of the plain version fed a keep mask (the path the
    dropout kernels are held to) against the JAX plain version fed the same
    mask through its weights_fn."""
    shape = (2, 11, 12, 2, 8)
    q, kk, v, g = _arrays(shape, seed=2)
    mask = torch_natten.dropout_keep_mask(7, (*shape[:4], k * k), 0.2)
    mask_np = mask.numpy()
    got_out, got = _torch_vjp(
        lambda *t: torch_natten.neighborhood_attention_2d(
            *t, k, dilation, weights_fn=lambda w: w * mask
        ),
        q, kk, v, g,
    )
    want_out, want = _jax_vjp(
        lambda *t: jax_natten.neighborhood_attention_2d(
            *t, k, dilation, weights_fn=lambda w: w * jnp.asarray(mask_np)
        ),
        q, kk, v, g,
    )
    np.testing.assert_allclose(got_out, want_out, atol=ATOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=ATOL)


def _mix32(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def _keep_bit(seed: int, query: int, slot: int, threshold: int) -> bool:
    """na2d_common.cuh::keep_bit with Python integers."""
    x = _mix32((seed & 0xFFFFFFFF) ^ 0x9E3779B9)
    x = _mix32(x ^ (query & 0xFFFFFFFF))
    x = _mix32(x ^ (query >> 32))
    x = _mix32(x ^ slot)
    return (x >> 8) >= threshold


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 2])
def test_dropout_keep_mask_matches_integer_reference(seed):
    shape, p = (2, 3, 4, 2, 9), 0.2
    mask = torch_natten.dropout_keep_mask(seed, shape, p)
    threshold = int(np.ceil(p * 2**24))
    want = np.array(
        [
            [_keep_bit(seed, q, j, threshold) for j in range(shape[-1])]
            for q in range(int(np.prod(shape[:-1])))
        ]
    ).reshape(shape)
    np.testing.assert_array_equal(mask.numpy() > 0, want)
    np.testing.assert_allclose(mask.numpy()[want], np.float32(1 / (1 - p)))
    # A tensor seed on its device gives the same mask.
    same = torch_natten.dropout_keep_mask(
        torch.tensor([seed], dtype=torch.int32), shape, p
    )
    assert torch.equal(same, mask)


def test_dropout_keep_mask_rate_and_seeds():
    shape = (4, 50, 50, 4, 9)
    mask = torch_natten.dropout_keep_mask(3, shape, 0.2)
    assert torch.equal(mask, torch_natten.dropout_keep_mask(3, shape, 0.2))
    assert abs((mask > 0).double().mean().item() - 0.8) <= 0.002
    other = torch_natten.dropout_keep_mask(4, shape, 0.2)
    assert (other != mask).double().mean().item() > 0.2
    assert torch.all(torch_natten.dropout_keep_mask(3, shape, 0.0) == 1.0)
    with pytest.raises(ValueError, match="dropout rate"):
        torch_natten.dropout_keep_mask(3, shape, 1.0)


def test_na2d_cpu_dropout_is_the_plain_version_with_the_mask():
    shape = (2, 9, 11, 4, 8)
    q, k, v = (torch.from_numpy(a) for a in _arrays(shape, count=3, seed=3))
    seed = torch.tensor([99], dtype=torch.int32)
    before = dict(natten_cuda.LAUNCHES)
    got = torch_natten.na2d(q, k, v, 3, 2, attn_drop=0.2, seed=seed)
    assert natten_cuda.LAUNCHES == before
    mask = torch_natten.dropout_keep_mask(99, (*shape[:4], 9), 0.2)
    want = torch_natten.neighborhood_attention_2d(
        q, k, v, 3, 2, weights_fn=lambda w: w * mask
    )
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="seed"):
        torch_natten.na2d(q, k, v, 3, 2, attn_drop=0.2)


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 9, 9, 1, 4)
    seed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        natten_cuda.launch_na2d_bwd(q, q, q, q, 3, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        natten_cuda.launch_na2d_fwd(q, q, q, 3, 1, 0.2, seed)


def test_attention_module_dropout_draws_from_the_generator():
    torch.manual_seed(0)
    module = NeighborhoodAttention2D(16, 2, 3, 1, attn_drop=0.5, proj_drop=0.5)
    x = torch.from_numpy(_arrays((2, 9, 9, 16), count=1, seed=4)[0])
    module.eval()
    plain = module(x)
    module.train()
    with pytest.raises(RuntimeError, match="generator"):
        module(x)
    state = torch.get_rng_state()
    runs = []
    for seed in (1, 1, 2):
        with dropout_rng(torch.Generator().manual_seed(seed)):
            runs.append(module(x))
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], plain)
