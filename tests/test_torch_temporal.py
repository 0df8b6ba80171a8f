"""The port's temporal-transformer front end against the JAX package, fp32
on the CPU: the attention op (plain version) against ``_attend_t_axis`` and
the Pallas kernel in interpret mode, the TemporalTransformer module, the
transformer-config CultioNet's eval forward, and the trained transformer
checkpoint's golden raster. Its train steps are in
``test_torch_temporal_train.py``.

Tolerances: op forward 2e-5, op gradients 3e-5 (fp32 in another order of
summation); module 5e-5; model 1e-4 as ``test_torch_model.py`` (a random
network amplifies fp32 round-off, ROADMAP "conditioning note"); golden
raster >= 99.9% of uint16 pixels equal, the JAX package's own gate.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.models import temporal as jax_temporal
from cultionet_tpu.ops import flags as jax_flags
from cultionet_tpu.ops.temporal_pallas import temporal_attention_pallas
from cultionet_tpu_torch.models import CultioNet, TemporalTransformer
from cultionet_tpu_torch.models.temporal import sinusoid_encoding_table
from cultionet_tpu_torch.nn.init import init_parameters_
from cultionet_tpu_torch.ops import temporal as torch_temporal
from cultionet_tpu_torch.ops import temporal_cuda
from cultionet_tpu_torch.predict import ScenePredictor
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from torch_port_helpers import (
    jax_transformer_model,
    port_transformer_model,
    restore_golden_checkpoint,
    seeded_variables,
)

DATA = Path(__file__).parent / "data"
OUTPUTS = ("distance", "edge", "crop")


def _pixel_major(x: np.ndarray) -> torch.Tensor:
    """(B, T, H, W, C) -> the port's (B*H*W, T, C)."""
    b, t, h, w, c = x.shape
    return torch.from_numpy(
        np.ascontiguousarray(x.transpose(0, 2, 3, 1, 4).reshape(-1, t, c))
    )


def _batch_major(x: torch.Tensor, shape) -> np.ndarray:
    """The port's (B*H*W, T, C) -> (B, T, H, W, C)."""
    b, _, h, w, _ = shape
    t, c = x.shape[1:]
    return x.detach().numpy().reshape(b, h, w, t, c).transpose(0, 3, 1, 2, 4)


# (C, heads, Tq, S, (B, H, W)): the first at a ragged N = 117, then the
# pooling query (Tq = 1), and 3 heads of 32 (which the Pallas kernel, C
# dividing 128, does not take).
OP_CASES = [
    (64, 4, 5, 5, (1, 9, 13)),
    (32, 2, 5, 5, (2, 3, 4)),
    (8, 4, 5, 5, (2, 3, 5)),
    (64, 4, 1, 6, (2, 5, 5)),
    (96, 3, 6, 6, (1, 4, 5)),
]


def _value_and_grads(fn):
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)

    return run


@pytest.mark.parametrize("channels,heads,tq,s_len,bhw", OP_CASES)
def test_attention_matches_jax(channels, heads, tq, s_len, bhw):
    b, h, w = bhw
    rng = np.random.default_rng(channels + tq)
    q = rng.normal(size=(b, tq, h, w, channels)).astype("float32")
    k, v = (
        rng.normal(size=(b, s_len, h, w, channels)).astype("float32")
        for _ in range(2)
    )
    g = rng.normal(size=q.shape).astype("float32")

    leaves = [_pixel_major(a).requires_grad_() for a in (q, k, v)]
    out = torch_temporal.temporal_attention_reference(*leaves, heads)
    grads = torch.autograd.grad(out, leaves, _pixel_major(g))
    got = [_batch_major(out, q.shape)] + [
        _batch_major(d, a.shape) for d, a in zip(grads, (q, k, v))
    ]

    # The XLA oracle compiled whole; the interpret-mode kernel runs eagerly
    # (faster on the CPU than compiled).
    oracles = [jax.jit(_value_and_grads(
        lambda q, k, v: jax_temporal._attend_t_axis(q, k, v, heads)
    ))]
    if 128 % channels == 0:
        oracles.append(_value_and_grads(
            lambda q, k, v: temporal_attention_pallas(q, k, v, heads, True)
        ))
    for oracle in oracles:
        want, want_grads = oracle(*map(jnp.asarray, (q, k, v, g)))
        np.testing.assert_allclose(got[0], np.asarray(want), atol=2e-5)
        for name, a, b_ in zip("qkv", got[1:], want_grads):
            np.testing.assert_allclose(
                a, np.asarray(b_), atol=3e-5, err_msg=f"d{name}"
            )


def test_attention_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(7, 5, 16)).astype("float32"))
               for _ in range(3))
    before = dict(temporal_cuda.LAUNCHES)
    got = torch_temporal.temporal_attention(q, k, v, 4)
    assert temporal_cuda.LAUNCHES == before
    torch.testing.assert_close(
        got, torch_temporal.temporal_attention_reference(q, k, v, 4),
        rtol=0, atol=0,
    )


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(6, 4, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        temporal_cuda.launch_temporal_fwd(q, q, q, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        temporal_cuda.temporal_attention_cuda(q, q, q, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        temporal_cuda.launch_temporal_bwd(q, q, q, q, 4)
    with pytest.raises(ValueError, match="do not divide"):
        torch_temporal.temporal_attention(q, q, q, 3)


def test_sinusoid_table_matches_jax():
    np.testing.assert_array_equal(
        sinusoid_encoding_table(13, 8),
        jax_temporal.sinusoid_encoding_table(13, 8),
    )


@pytest.mark.parametrize("packed", [False, True])
def test_module_matches_jax(packed):
    """The port against the JAX module's unpacked path and its packed path
    with the interpret-mode Pallas kernel (d_model 32, T = 12)."""
    jm = jax_temporal.TemporalTransformer(
        out_channels=16, d_model=32, num_heads=4, num_layers=2, dropout=0.2
    )
    x = np.random.default_rng(1).normal(size=(2, 12, 6, 5, 3)).astype("float32")
    try:
        jax_flags.set_pallas_temporal(packed)
        variables = seeded_variables(jm, jnp.asarray(x), training=False, seed=2)
        want = jax.jit(lambda v, x: jm.apply(v, x, training=False))(
            variables, jnp.asarray(x)
        )
    finally:
        jax_flags.set_pallas_temporal(None)

    tm = TemporalTransformer(3, 16, 12, d_model=32, num_heads=4, dropout=0.2)
    load_flax(tm, variables).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 16, 6, 5)
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=5e-5
    )


@pytest.mark.parametrize("hidden", [8, 16])
def test_eval_forward_matches_jax(hidden):
    jm, variables = jax_transformer_model(hidden)
    x = np.random.default_rng(hidden).random((2, 6, 44, 44, 3)).astype("float32")
    want = jax.jit(lambda v, x: jm.apply(v, JaxBatch(x=x), training=False))(
        variables, jnp.asarray(x)
    )
    tm = load_flax(port_transformer_model(hidden), variables).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for name in OUTPUTS:
        assert got[name].shape == (2, 44, 44, 1)
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(want[name]), atol=1e-4, err_msg=name
        )


def test_translator_consumes_every_transformer_leaf():
    _, variables = jax_transformer_model(8)
    pre_unet = variables["params"]["mask_model"]["pre_unet"]
    assert set(pre_unet) == (
        {f"Dense_{i}" for i in range(13)}
        | {f"LayerNorm_{i}" for i in range(7)}
        | {"pool_query"}
    )
    state = from_flax(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    assert state["mask_model.pre_unet.pool_query"].shape == (1, 1, 1, 1, 8)
    tm = port_transformer_model(8)
    torch_keys = {
        k for k in tm.state_dict() if not k.endswith("num_batches_tracked")
    }
    assert torch_keys == set(state)
    load_flax(tm, variables)
    np.testing.assert_array_equal(
        tm.mask_model.pre_unet.Dense_1.weight.detach().numpy(),
        pre_unet["Dense_1"]["kernel"].T,
    )


def test_transformer_needs_a_known_encoder():
    with pytest.raises(ValueError, match="temporal_encoder"):
        CultioNet(in_time=6, hidden_channels=8, temporal_encoder="lstm")


def test_trained_checkpoint_matches_golden_raster():
    """The trained transformer checkpoint (hidden 8, T = 13), translated,
    through the port's ScenePredictor in fp32 on the CPU over the golden
    scene: the same inputs and gate as the JAX package's
    test_fused_scene_predict_matches_golden_raster[transformer]."""
    from cultionet_tpu.data.constant import SCALE_FACTOR
    from cultionet_tpu.data.tiny_tiff import read_tiff

    golden_dir = DATA / "golden_transformer"
    golden, *_ = read_tiff(golden_dir / "golden.tif")
    state, jax_model = restore_golden_checkpoint(
        golden_dir / "ckpt" / "last_store"
    )
    assert jax_model.temporal_encoder == "transformer"
    model = CultioNet(
        in_time=jax_model.in_time,
        hidden_channels=jax_model.hidden_channels,
        dilations=jax_model.dilations,
        dropout=jax_model.dropout,
        activation_type=jax_model.activation_type,
        attention_weights=jax_model.attention_weights,
        temporal_encoder="transformer",
    )
    load_flax(
        model, {"params": state.params, "batch_stats": state.batch_stats}
    )
    with np.load(DATA / "golden" / "scene.npz", allow_pickle=False) as data:
        x = data["x"].astype(np.float32) / SCALE_FACTOR
    predictor = ScenePredictor(
        model, batch_size=4, precision="fp32", device="cpu"
    )
    raster, _ = predictor.predict_scene(x, window_size=50, padding=10)
    packed = np.moveaxis(
        np.clip(raster * SCALE_FACTOR, 0, 65535).astype("uint16"), -1, 0
    )
    assert packed.shape == golden.shape
    match = float(np.mean(packed == golden))
    assert match >= 0.999, f"pixel match {match:.5f} < 0.999"


def test_transformer_init_distributions():
    """The JAX module's init: MLP Dense layers at flax's default
    (lecun-normal, truncated at 2 sigma; zero bias), pool_query N(0, 0.02),
    every other Dense He-normal with N(0, 1) biases."""
    tm = TemporalTransformer(3, 64, 12, d_model=64)
    init_parameters_(tm, torch.Generator().manual_seed(0))
    for i in (3, 4, 7, 8):  # Dense_{4l+3}, Dense_{4l+4}
        layer = getattr(tm, f"Dense_{i}")
        fan_in = layer.weight.shape[1]
        assert float(layer.bias.detach().abs().max()) == 0.0
        assert float(layer.weight.detach().std()) == pytest.approx(
            fan_in**-0.5, rel=0.05
        )
        assert float(layer.weight.detach().abs().max()) <= 2.0 * (
            fan_in**-0.5 / 0.87962566103423978
        ) + 1e-6
    for i in (0, 1, 2, 5, 6, 9, 10, 11, 12):
        layer = getattr(tm, f"Dense_{i}")
        fan_in = layer.weight.shape[1]
        assert float(layer.weight.detach().std()) == pytest.approx(
            (2.0 / fan_in) ** 0.5, rel=0.1
        )
        assert float(layer.bias.detach().std()) == pytest.approx(1.0, rel=0.35)
    query = tm.pool_query.detach()
    assert query.shape == (1, 1, 1, 1, 64)
    assert 0.01 < float(query.std()) < 0.03
    assert float(query.abs().max()) > 0
