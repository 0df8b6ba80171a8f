"""The model options off the CLI default (``--res-block-type res``,
``--attention-weights spatial_channel|none``, ``--pool-by-max``,
``--batchnorm-first``, ``--use-latlon``) in the port against the JAX
package, from ``from_flax`` weights of ``seeded_variables`` (which moves
both gammas of the spatial-channel gate off their init values).

Each new module alone: ``adaptive_max_pool_half`` at even and odd sides
(also against ``F.adaptive_max_pool2d``), the BN-first ``ConvBlock2d``,
``PoolResidualConv``'s three downsampling paths under both residual
blocks, ``ResidualConv`` and ``ResidualAConv`` with the gate,
``GeoEmbeddings`` and ``DepthwiseSeparableConv``, fp32 to 1e-5. A
'res' block with NATTEN is refused by both packages.

The whole CultioNet per option at hidden 8, T = 6, 2 x 44 x 44 (cases of
one option share one JAX model, ``option`` below; running statistics
estimated from the batch, ``calibrated_batch_stats``): ``load_flax``
strict with every leaf consumed; the eval forward within 1e-4 in fp32; in
bf16 within 2e-2 beyond JAX's own bf16 distance from its fp32 outputs and
within 2e-2 of JAX's bf16 outputs on average (``check_eval_forward``),
with JAX's types for the encoder's, the decoder's, the towers' and the
model's outputs (fp32 from the towers on under ``use_latlon``, as the JAX
model promotes); one dropout-0 fp32 train step's losses within 1e-5 of
the JAX training forward's, and the running statistics it leaves within
1e-5 + 1e-4 of their size (``check_train_step``). This file holds O1-O3
(the residual block and attention options);
``test_torch_model_options_more.py`` holds O4-O6 with the same check.
"""

import copy
import typing as T

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.models.unet_parts import GeoEmbeddings as JaxGeoEmbeddings
from cultionet_tpu.nn import blocks as jax_blocks
from cultionet_tpu.train import step as jax_step
from cultionet_tpu.train.precision import cast_floating as jax_cast
from cultionet_tpu_torch.data.synthetic import create_batch
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.models.unet_parts import GeoEmbeddings
from cultionet_tpu_torch.nn import blocks
from cultionet_tpu_torch.train import optim as torch_optim
from cultionet_tpu_torch.train import step as torch_step
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from torch_port_helpers import seeded_variables

LOSS = "TanimotoComplementLoss"
OUTPUTS = ("distance", "edge", "crop")
OPTIONS = {
    "res-spatial_channel": dict(
        res_block_type="res", attention_weights="spatial_channel"
    ),
    "res-none": dict(res_block_type="res", attention_weights=None),
    "resa-spatial_channel": dict(attention_weights="spatial_channel"),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread: the test runner's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def check_module(jax_module, port_module, x_nhwc, atol=1e-5, seed=0):
    """The flax module and the port's on ``seeded_variables`` weights, in
    eval mode, on the same NHWC input."""
    variables = seeded_variables(jax_module, jnp.asarray(x_nhwc), seed=seed)
    want = np.asarray(jax_module.apply(variables, jnp.asarray(x_nhwc)))
    load_flax(port_module, variables).eval()
    with torch.no_grad():
        got = port_module(nchw(x_nhwc)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize(
    "size", [(44, 44), (22, 22), (11, 11), (35, 35), (35, 44)]
)
def test_adaptive_max_pool_half(size):
    x = np.random.default_rng(0).normal(size=(2, *size, 3)).astype("float32")
    want = np.asarray(jax_blocks.adaptive_max_pool_half(jnp.asarray(x)))
    got = blocks.adaptive_max_pool_half(nchw(x))
    assert got.shape[-2:] == (size[0] // 2, size[1] // 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    torch.testing.assert_close(
        got, F.adaptive_max_pool2d(nchw(x), (size[0] // 2, size[1] // 2)),
        rtol=0, atol=0,
    )


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_batchnorm_first_conv_block(training):
    """BN over the input channels, activation, conv with bias; in training
    the running statistics of the input channels update as flax's."""
    x = np.random.default_rng(1).normal(size=(2, 9, 9, 4)).astype("float32")
    jm = jax_blocks.ConvBlock2d(
        out_channels=6, kernel_size=3, padding=1, batchnorm_first=True
    )
    variables = seeded_variables(jm, jnp.asarray(x), seed=1)
    want, mutated = jm.apply(
        variables, jnp.asarray(x), training=training, mutable=["batch_stats"]
    )
    tm = blocks.ConvBlock2d(4, 6, 3, padding=1, batchnorm_first=True)
    load_flax(tm, variables).train(training)
    assert tm.BatchNorm_0.BatchNorm_0.num_features == 4
    assert tm.Conv_0.bias is not None
    with torch.no_grad():
        got = tm(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    stats = from_flax({"batch_stats": mutated["batch_stats"]})
    for name, value in stats.items():
        np.testing.assert_allclose(
            tm.state_dict()[name].numpy(), value.numpy(), atol=1e-6,
            err_msg=name,
        )


@pytest.mark.parametrize("res_block_type", ["resa", "res"])
@pytest.mark.parametrize(
    "downsample", ["pool_by_max", "batchnorm_first", "strided_conv"]
)
def test_pool_residual_conv(downsample, res_block_type):
    """The three downsampling paths on an odd side (11 -> 5 by the max
    pool, 6 by the strided convs), under either residual block."""
    x = np.random.default_rng(2).normal(size=(2, 11, 11, 4)).astype("float32")
    flags = dict(
        pool_by_max=downsample == "pool_by_max",
        batchnorm_first=downsample == "batchnorm_first",
    )
    jm = jax_blocks.PoolResidualConv(
        out_channels=8, dilations=[1, 2], res_block_type=res_block_type,
        **flags,
    )
    tm = blocks.PoolResidualConv(
        4, 8, dilations=[1, 2], res_block_type=res_block_type, **flags
    )
    check_module(jm, tm, x, seed=2)


@pytest.mark.parametrize("block", ["ResidualConv", "ResidualAConv"])
def test_residual_blocks_with_spatial_channel_gate(block):
    x = np.random.default_rng(3).normal(size=(2, 9, 9, 4)).astype("float32")
    jm = getattr(jax_blocks, block)(
        out_channels=8, attention_weights="spatial_channel"
    )
    tm = getattr(blocks, block)(4, 8, attention_weights="spatial_channel")
    check_module(jm, tm, x, seed=3)


def test_depthwise_separable_conv():
    x = np.random.default_rng(4).normal(size=(2, 9, 9, 4)).astype("float32")
    check_module(
        jax_blocks.DepthwiseSeparableConv(out_channels=8, kernel_size=3),
        blocks.DepthwiseSeparableConv(4, 8, 3),
        x,
        seed=4,
    )


def test_geo_embeddings():
    coords = np.array(
        [[-100.0, 40.5], [30.25, -12.0], [179.0, 89.0]], dtype="float32"
    )
    jm = JaxGeoEmbeddings(channels=8)
    variables = seeded_variables(jm, jnp.asarray(coords), seed=5)
    want = np.asarray(jm.apply(variables, jnp.asarray(coords)))
    tm = load_flax(GeoEmbeddings(8), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_front_end_gradients_match_jax(batch_size):
    """The conv temporal front end in training mode: its parameters'
    gradients under a fixed projection within 1e-5 of the largest of
    JAX's. At batch 1 a view between the port's BatchNorm and the
    channels-last LayerNorm once made them 100% off on the CPU."""
    from cultionet_tpu.models.temporal import PreTimeReduction as JaxFront
    from cultionet_tpu_torch.models.temporal import PreTimeReduction

    rng = np.random.default_rng(6)
    x = rng.random((batch_size, 6, 12, 12, 3)).astype("float32")
    weights = rng.normal(size=(batch_size, 12, 12, 8)).astype("float32")
    jm = JaxFront(out_channels=8, in_time=6)
    variables = seeded_variables(jm, jnp.asarray(x), training=True, seed=6)

    def project(params, stats):
        out, _ = jm.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            training=True, mutable=["batch_stats"],
        )
        return (out * weights).sum()

    want = from_flax(
        {"params": jax.jit(jax.grad(project))(
            variables["params"], variables["batch_stats"]
        )}
    )
    tm = load_flax(PreTimeReduction(3, 8, 6), variables).train()
    out = tm(torch.from_numpy(x)).permute(0, 2, 3, 1)
    (out * torch.from_numpy(weights)).sum().backward()
    top = max(float(v.abs().max()) for v in want.values())
    for name, param in tm.named_parameters():
        diff = float((param.grad - want[name]).abs().max())
        assert diff <= 1e-5 * top, (name, diff, top)


def test_res_block_with_natten_is_refused():
    """--res-block-type res with the default --attention-weights natten:
    the JAX ResidualConv asserts, the port raises ValueError naming the
    rule when the model is built."""
    jm = JaxCultioNet(
        in_time=6, hidden_channels=8, res_block_type="res",
        attention_weights="natten",
    )
    with pytest.raises(AssertionError):
        jax.eval_shape(
            lambda: jm.init(
                jax.random.PRNGKey(0),
                JaxBatch(x=jnp.zeros((1, 6, 16, 16, 3))),
            )
        )
    with pytest.raises(ValueError, match="spatial_channel"):
        CultioNet(
            in_time=6, hidden_channels=8, res_block_type="res",
            attention_weights="natten",
        )


# -- the whole model, one JAX model per option --------------------------


def jax_batch(batch) -> JaxBatch:
    return JaxBatch(
        **{
            name: jnp.asarray(getattr(batch, name).numpy())
            for name in ("x", "y", "bdist", "lat", "lon")
        }
    )


def calibrated_batch_stats(model, batch, variables, passes: int = 10) -> dict:
    """The flax ``batch_stats`` tree with the running statistics that
    ``passes`` training-mode forwards of the port's ``model`` (no
    gradient) leave on ``batch``. Seeded statistics far from the data's
    make a random network amplify rounding: JAX's own bf16 forward then
    lies up to 0.3 from its fp32 one, also for the default model; with
    statistics estimated as a trained model's are, it lies within about
    0.05 (``chip_smoke.py::build_model`` estimates them on the card for
    the same reason)."""
    model.train()
    with torch.no_grad():
        for _ in range(passes):
            model(batch.x, batch.lat, batch.lon)
    model.eval()
    buffers = model.state_dict()
    names = {"mean": "running_mean", "var": "running_var"}

    def visit(tree, path):
        return {
            key: visit(value, path + [key])
            if hasattr(value, "items")
            else buffers[".".join(path + [names[key]])].numpy().copy()
            for key, value in tree.items()
        }

    return visit(variables["batch_stats"], [])


def build_option(kwargs: dict, seed: int) -> dict:
    """The JAX CultioNet of one option (hidden 8, T = 6, dilations [1, 2],
    dropout 0) with seeded variables whose running statistics are then
    estimated from the batch (``calibrated_batch_stats``), the port's on
    the same weights (``load_flax``, strict), and a 2 x 44 x 44 batch
    with centroids."""
    jm = JaxCultioNet(
        in_time=6, hidden_channels=8, dilations=[1, 2], dropout=0.0, **kwargs
    )
    batch = create_batch(
        num_channels=3, num_time=6, height=44, width=44, batch_size=2,
        rng=np.random.default_rng(seed),
    ).with_centroids()
    jb = jax_batch(batch)
    variables = seeded_variables(jm, jb, training=False, seed=seed)
    model = CultioNet(
        in_time=6, in_channels=3, hidden_channels=8, dilations=[1, 2],
        dropout=0.0, **kwargs,
    )
    load_flax(model, variables)
    variables = {
        **variables,
        "batch_stats": calibrated_batch_stats(model, batch, variables),
    }
    return dict(
        jax_model=jm, variables=variables, model=model, batch=batch,
        jax_batch=jb,
    )


def check_translation(case):
    state = from_flax(case["variables"])
    assert len(state) == len(jax.tree_util.tree_leaves(case["variables"]))
    assert set(state) == {
        k for k in case["model"].state_dict()
        if not k.endswith("num_batches_tracked")
    }


SEGMENTS = ("encoder", "decoder", "tower_fusion")


def jax_eval_forward(case, dtype: str) -> T.Tuple[dict, dict]:
    """The JAX eval forward in ``dtype`` (variables cast as the JAX steps
    cast them; lat/lon fp32), computed once per option: the outputs, and
    the output dicts of the encoder, the decoder and the fusion."""
    cache = case.setdefault("jax_eval", {})
    if dtype not in cache:
        jm, jb = case["jax_model"], case["jax_batch"]
        variables = jax_cast(
            jax.tree_util.tree_map(jnp.asarray, case["variables"]),
            getattr(jnp, dtype),
        )

        def forward(v, b):
            return jm.apply(
                v, b, training=False, mutable=["intermediates"],
                capture_intermediates=lambda mdl, _: mdl.name in SEGMENTS,
            )

        outputs, state = jax.jit(forward)(
            variables, jb.replace(x=jb.x.astype(getattr(jnp, dtype)))
        )
        captured = state["intermediates"]["mask_model"]
        cache[dtype] = outputs, {
            name: captured[name]["__call__"][0] for name in SEGMENTS
        }
    return cache[dtype]


def port_eval_forward(case, dtype: str) -> T.Tuple[dict, dict]:
    """The port's eval forward in ``dtype`` on a cast copy of the model:
    the outputs, and the output dicts of its three segments."""
    batch = case["batch"]
    model = copy.deepcopy(case["model"]).eval().to(getattr(torch, dtype))
    segments = {}
    for name in SEGMENTS:
        getattr(model.mask_model, name).register_forward_hook(
            lambda module, args, out, name=name: segments.setdefault(name, out)
        )
    with torch.no_grad():
        outputs = model(
            batch.x.to(getattr(torch, dtype)), batch.lat, batch.lon
        )
    return outputs, segments


def dtype_name(value) -> str:
    return str(value.dtype).split(".")[-1]


def check_eval_forward(case, dtype):
    """The port's eval forward in ``dtype`` against JAX's, with JAX's
    output types. fp32: within 1e-4. bf16: JAX's own bf16 forward lies up
    to about 0.05 from its fp32 one (so does the default model's), so two
    bf16 forwards that round at other places cannot agree to 2e-2
    everywhere; the port's bf16 outputs lie within 2e-2 of the fp32 JAX
    outputs beyond JAX's bf16 distance from them, and within 2e-2 of JAX's
    bf16 outputs on average."""
    want, want_segments = jax_eval_forward(case, dtype)
    reference, _ = jax_eval_forward(case, "float32")
    got, segments = port_eval_forward(case, dtype)
    for segment, values in want_segments.items():
        assert {k: dtype_name(v) for k, v in segments[segment].items()} == {
            k: dtype_name(v) for k, v in values.items()
        }, segment
    for name in OUTPUTS:
        assert dtype_name(got[name]) == dtype_name(want[name])
        assert got[name].shape == (2, 44, 44, 1)
        value = got[name].float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(
                value, np.asarray(want[name]), atol=1e-4, err_msg=name
            )
            continue
        ref = np.asarray(reference[name])
        jax_bf16 = np.asarray(want[name].astype(jnp.float32))
        jax_err = float(np.abs(jax_bf16 - ref).max())
        port_err = float(np.abs(value - ref).max())
        assert port_err <= jax_err + 2e-2, (name, port_err, jax_err)
        assert float(np.abs(value - jax_bf16).mean()) <= 2e-2, name


def check_train_step(case):
    """One fp32 dropout-0 port train step against the JAX training forward
    on the same weights: its losses within 1e-5, and the running
    statistics it leaves within 1e-5 plus 1e-4 of their size. JAX's fp32
    statistics themselves lie up to 1e-4 (relative) from the port's
    computed in fp64 (pool_by_max, the bottleneck's 5 x 5 maps), where the
    port's fp32 ones lie within 3e-6."""
    jm, jb, variables = case["jax_model"], case["jax_batch"], case["variables"]

    def train_forward(params, stats, batch):
        outputs, mutated = jm.apply(
            {"params": params, "batch_stats": stats},
            batch,
            training=True,
            mutable=["batch_stats"],
        )
        loss, report = jax_step.calc_loss(outputs, batch, loss_name=LOSS)
        return {"loss": loss, **report}, mutated["batch_stats"]

    want, stats = jax.jit(train_forward)(
        variables["params"], variables["batch_stats"], jb
    )
    state = torch_step.create_train_state(
        copy.deepcopy(case["model"]),
        torch_optim.build_optimizer("AdamW", 1e-3),
        device="cpu",
    )
    step = torch_step.make_train_step(loss_name=LOSS, device="cpu")
    state, logs = step(state, case["batch"], torch.Generator().manual_seed(0))
    for name in ("loss", "dloss", "eloss", "closs"):
        np.testing.assert_allclose(
            float(logs[name]), float(want[name]), atol=1e-5, err_msg=name
        )
    got = state.model.state_dict()
    for name, value in from_flax({"batch_stats": stats}).items():
        np.testing.assert_allclose(
            got[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-5,
            err_msg=name,
        )


@pytest.fixture(scope="module", params=list(OPTIONS))
def option(request):
    return build_option(
        OPTIONS[request.param], seed=list(OPTIONS).index(request.param)
    )


def test_translation_is_strict(option):
    check_translation(option)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_matches_jax(option, dtype):
    check_eval_forward(option, dtype)


def test_train_step_matches_jax(option):
    check_train_step(option)
