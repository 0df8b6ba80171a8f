"""The reference checkpoint importer of the port
(``cultionet_tpu_torch/utils/torch_params.py``, the CLI's ``import-torch``
and the natten stand-in of ``utils/torch_import.py``) against the JAX
package's.

The checkpoints come from ``torch_reference_keys.py``: reference names for
a model's weights, the inverse of the translator's naming rules. That
helper is held first: JAX's own ``translate_state_dict`` maps its output
back to the JAX variables leaf for leaf, exactly. Then, for each option set
JAX's translator names (the CLI default resa + natten, res +
spatial_channel, res + none, resa + spatial_channel, pool_by_max,
batchnorm_first), at hidden 8, T = 6, 2 x 32 x 32, with running statistics
estimated from the batch (``calibrated_batch_stats``; seeded ones make
a random network amplify rounding):

- the port's ``translate_state_dict`` equals JAX's key for key and array
  for array;
- the port's model after ``import_torch_state_dict`` equals ``load_flax``
  of JAX's ``import_torch_state_dict`` result, tensor for tensor, and its
  fp32 eval forward lies within 1e-5 of JAX's (measured: at most 2.7e-6).

Failures and prefixes: an unplaceable entry and a wrong shape raise in
both packages, naming the same entries, and leave the port's model as it
was; a dropped entry keeps its initial value in both; the
``cultionet_model.`` and ``mask_model.`` prefixes and ``_orig_mod``
segments translate as in JAX; ``load_reference_checkpoint`` reads a
Lightning file in both.

The command line is held in ``test_torch_import_torch_cli.py``.

The natten stand-in equals JAX's and the port's plain neighborhood
attention; ``install_reference_stubs`` is idempotent and never shadows an
installed package. The last test holds the port to the reference model
itself and skips while its sources are not in the repository.
"""

import copy
import sys
import typing as T

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cultionet_tpu.data.batch import Batch as JaxBatch
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu.models.tower_unet import TowerUNet as JaxTowerUNet
from cultionet_tpu.utils import torch_import as jax_torch_import
from cultionet_tpu.utils import torch_params as jtp
from cultionet_tpu_torch.data.synthetic import create_batch
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.models.tower_unet import TowerUNet
from cultionet_tpu_torch.scripts import cli
from cultionet_tpu_torch.utils import torch_import
from cultionet_tpu_torch.utils import torch_params as ptp
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from test_torch_model_options import calibrated_batch_stats
from torch_port_helpers import one_torch_thread, seeded_variables  # noqa: F401
from torch_reference_keys import reference_state_dict

OPTIONS = {
    "default": {},
    "res-spatial_channel": dict(
        res_block_type="res", attention_weights="spatial_channel"
    ),
    "res-none": dict(res_block_type="res", attention_weights=None),
    "resa-spatial_channel": dict(attention_weights="spatial_channel"),
    "pool_by_max": dict(pool_by_max=True),
    "batchnorm_first": dict(batchnorm_first=True),
}
MODEL = dict(in_time=6, hidden_channels=8, dilations=[1, 2], dropout=0.0)
OUTPUTS = ("distance", "edge", "crop")


def flat(tree, path=()) -> T.Dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(flat(value, path + (key,)))
        else:
            out[path + (key,)] = np.asarray(value)
    return out


def jax_batch(batch) -> JaxBatch:
    return JaxBatch(
        **{
            name: jnp.asarray(getattr(batch, name).numpy())
            for name in ("x", "y", "bdist", "lat", "lon")
        }
    )


def build_case(kwargs: dict, seed: int = 0) -> dict:
    """One option: the JAX CultioNet with seeded variables (statistics
    estimated on the batch), the port's model on them (the checkpoint's
    source), and the reference ``state_dict`` of its weights."""
    jm = JaxCultioNet(**MODEL, **kwargs)
    batch = create_batch(
        num_channels=3, num_time=6, height=32, width=32, batch_size=2,
        rng=np.random.default_rng(seed),
    )
    jb = jax_batch(batch)
    variables = seeded_variables(jm, jb, training=False, seed=seed)
    source = CultioNet(in_channels=3, **MODEL, **kwargs)
    load_flax(source, variables)
    variables = {
        **variables,
        "batch_stats": calibrated_batch_stats(source, batch, variables),
    }
    return dict(
        kwargs=kwargs, jax_model=jm, batch=batch, jax_batch=jb,
        variables=variables, source=source,
        reference=reference_state_dict(source.state_dict()),
    )


@pytest.fixture(scope="module", params=list(OPTIONS))
def case(request):
    return build_case(OPTIONS[request.param])


@pytest.fixture(scope="module")
def default_case():
    return build_case({})


def fresh_model(kwargs: dict, seed: int = 1) -> CultioNet:
    torch.manual_seed(seed)
    return CultioNet(in_channels=3, **MODEL, **kwargs).eval()


def jax_import(case, state_dict, prefix: str = "") -> dict:
    """JAX's importer into a template of other seeded variables."""
    template = seeded_variables(
        case["jax_model"], case["jax_batch"], training=False, seed=7
    )
    return jtp.import_torch_state_dict(state_dict, template, prefix=prefix)


def assert_same_model(model, variables) -> None:
    want = load_flax(copy.deepcopy(model), variables).state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for key in got:
        if key.endswith("num_batches_tracked"):
            continue
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


# -- the reference-key helper and the translators ----------------------


def test_reference_keys_round_trip_through_jax(case):
    """JAX's translator maps the helper's names back to the variables,
    leaf for leaf; the helper on ``from_flax`` of the JAX variables and on
    the port's ``state_dict`` gives the same checkpoint."""
    params, stats = jtp.translate_state_dict(case["reference"])
    for got, tree in ((params, case["variables"]["params"]),
                      (stats, case["variables"]["batch_stats"])):
        want = flat(tree)
        assert set(got) == set(want)
        for path, value in want.items():
            assert got[path].shape == value.shape, path
            np.testing.assert_array_equal(got[path], value, err_msg=str(path))
    via_flax = reference_state_dict(from_flax(case["variables"]))
    weights = {k for k in case["reference"] if not k.endswith("num_batches_tracked")}
    assert set(via_flax) == weights
    for key in via_flax:
        np.testing.assert_array_equal(via_flax[key], case["reference"][key])


def test_port_translator_equals_jax(case):
    reference = case["reference"]
    for state_dict in (
        reference,
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in reference.items()},
    ):
        for got, want in zip(
            ptp.translate_state_dict(state_dict),
            jtp.translate_state_dict(state_dict),
        ):
            assert list(got) == list(want)
            for path in want:
                assert got[path].dtype == want[path].dtype, path
                np.testing.assert_array_equal(got[path], want[path])


def test_import_equals_jax_import(case):
    """The imported port model equals ``load_flax`` of JAX's import, and
    its fp32 eval forward lies within 1e-5 of JAX's."""
    model = fresh_model(case["kwargs"])
    count = ptp.import_torch_state_dict(case["reference"], model)
    new_vars = jax_import(case, case["reference"])
    assert count == len(jax.tree_util.tree_leaves(new_vars))
    assert_same_model(model, new_vars)

    want = jax.jit(
        lambda v, b: case["jax_model"].apply(v, b, training=False)
    )(new_vars, case["jax_batch"])
    with torch.no_grad():
        got = model(case["batch"].x)
    for name in OUTPUTS:
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(want[name]), rtol=0, atol=1e-5,
            err_msg=name,
        )


# -- failures and prefixes (the default option) --------------------------


def error_lines(exc: Exception) -> T.List[str]:
    return str(exc).splitlines()


def test_unplaceable_and_wrong_shape_raise_in_both(default_case):
    reference = dict(default_case["reference"])
    reference["mask_model.encoder.down_a.bogus.weight"] = np.zeros((3,), np.float32)
    reference["mask_model.pre_unet.layer_norm.1.extra"] = np.zeros((3,), np.float32)
    reference["mask_model.nowhere.seq.0.weight"] = np.zeros((4, 4, 3, 3), np.float32)
    conv = next(k for k in reference if k.endswith("seq.0.weight")
                and reference[k].ndim == 4)
    reference[conv] = np.zeros(reference[conv].shape[:-1] + (5,), np.float32)
    bias = next(k for k in reference if k.endswith("skip.bias"))
    reference[bias] = np.zeros(reference[bias].shape[0] + 1, np.float32)

    model = fresh_model({})
    before = copy.deepcopy(model.state_dict())
    with pytest.raises(ValueError) as port_err:
        ptp.import_torch_state_dict(reference, model)
    with pytest.raises(ValueError) as jax_err:
        jax_import(default_case, reference)
    assert error_lines(port_err.value) == error_lines(jax_err.value)
    lines = error_lines(port_err.value)
    assert lines[0].startswith("torch->flax import failed for 5/")
    assert len(lines) == 6
    text = str(port_err.value)
    for fragment in ("missing path: mask_model/encoder/down_a/bogus/kernel",
                     "missing leaf: mask_model/pre_unet/LayerNorm_0/extra",
                     "missing path: mask_model/nowhere/Conv_0/kernel",
                     "shape mismatch at", "skip/bias"):
        assert fragment in text
    # All or nothing: the port's model is as it was.
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_dropped_entry_keeps_its_initial_value(default_case):
    reference = dict(default_case["reference"])
    dropped = [k for k in reference if k.endswith("final_dist.0.weight")
               or k.endswith("pre_unet.conv3.seq.1.running_var")]
    assert len(dropped) == 2
    for key in dropped:
        del reference[key]
    model = fresh_model({})
    initial = copy.deepcopy(model.state_dict())
    ptp.import_torch_state_dict(reference, model)
    template = seeded_variables(
        default_case["jax_model"], default_case["jax_batch"], training=False, seed=7
    )
    new_vars = jtp.import_torch_state_dict(reference, template)
    port_keys = ("mask_model.final_combine.final_dist.weight",
                 "mask_model.pre_unet.conv3.BatchNorm_0.BatchNorm_0.running_var")
    jax_paths = (("params", "mask_model", "final_combine", "final_dist", "kernel"),
                 ("batch_stats", "mask_model", "pre_unet", "conv3", "BatchNorm_0",
                  "BatchNorm_0", "var"))
    for key, path in zip(port_keys, jax_paths):
        assert torch.equal(model.state_dict()[key], initial[key]), key
        node_new, node_old = new_vars, template
        for seg in path:
            node_new, node_old = node_new[seg], node_old[seg]
        np.testing.assert_array_equal(node_new, node_old)
    # Everything else is the checkpoint's.
    source = default_case["source"].state_dict()
    for key, value in model.state_dict().items():
        if key in port_keys or key.endswith("num_batches_tracked"):
            continue
        assert torch.equal(value, source[key]), key


def with_orig_mod(state_dict: dict) -> dict:
    """Keys as torch.compile'd modules name them: ``_orig_mod`` at the
    top and below ``mask_model``."""
    return {
        "_orig_mod." + k.replace("mask_model.", "mask_model._orig_mod.", 1): v
        for k, v in state_dict.items()
    }


def test_prefixes_and_orig_mod(default_case):
    reference = default_case["reference"]
    lightning = {f"cultionet_model.{k}": v for k, v in reference.items()}
    lightning["optimizer_only.weight"] = np.zeros((2,), np.float32)
    want = ptp.translate_state_dict(reference)
    for variant in (with_orig_mod(reference),):
        for got, jax_got, expected in zip(
            ptp.translate_state_dict(variant), jtp.translate_state_dict(variant), want
        ):
            assert list(got) == list(expected) == list(jax_got)
    # Lightning's prefix (other entries ignored) into CultioNet.
    model = fresh_model({})
    ptp.import_torch_state_dict(lightning, model, prefix="cultionet_model.")
    assert_same_model(model, jax_import(default_case, lightning, prefix="cultionet_model."))
    # A CultioNet state_dict into a bare TowerUNet, compiled names and all.
    tower = TowerUNet(in_channels=3, **MODEL)
    compiled = {f"cultionet_model.{k}": v for k, v in with_orig_mod(reference).items()}
    ptp.import_torch_state_dict(
        compiled, tower, prefix="cultionet_model._orig_mod.mask_model."
    )
    jm = JaxTowerUNet(**MODEL)
    template = seeded_variables(
        jm, default_case["jax_batch"].x, None, training=False, seed=3
    )
    tower_vars = jtp.import_torch_state_dict(
        compiled, template, prefix="cultionet_model._orig_mod.mask_model."
    )
    assert_same_model(tower, tower_vars)
    np.testing.assert_array_equal(
        tower.state_dict()["pre_unet.LayerNorm_0.weight"].numpy(),
        default_case["source"].state_dict()["mask_model.pre_unet.LayerNorm_0.weight"].numpy(),
    )


def test_load_reference_checkpoint(default_case, tmp_path):
    """A Lightning file through ``load_reference_checkpoint`` in both
    packages (its default prefix ``cultionet_model.``)."""
    from torch_reference_keys import lightning_checkpoint

    torch.save(
        lightning_checkpoint(default_case["source"].state_dict(), {"in_time": 6}),
        tmp_path / "last.ckpt",
    )
    model = fresh_model({})
    count = ptp.load_reference_checkpoint(str(tmp_path / "last.ckpt"), model)
    template = seeded_variables(
        default_case["jax_model"], default_case["jax_batch"], training=False, seed=7
    )
    new_vars = jtp.load_reference_checkpoint(str(tmp_path / "last.ckpt"), template)
    assert count == len(jax.tree_util.tree_leaves(new_vars))
    assert_same_model(model, new_vars)


def test_values_cast_to_the_model_dtype(default_case):
    reference = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in default_case["reference"].items()}
    model = fresh_model({})
    ptp.import_torch_state_dict(reference, model)
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert value.dtype == torch.float32, key
    assert_same_model(model, jax_import(default_case, default_case["reference"]))


HYPER = dict(
    in_channels=3, in_time=6, hidden_channels=8, dropout=0.0,
    activation_type="SiLU", dilations=[1, 2], res_block_type="resa",
    attention_weights="natten", pool_by_max=False, batchnorm_first=False,
)


# -- the natten stand-in and the stubs ----------------------------------


@pytest.fixture
def restored_imports(monkeypatch):
    """Undo what installing the stubs changes: ``sys.meta_path``, the
    natten modules, the stub modules made meanwhile, the installed flags."""
    before = set(sys.modules)
    monkeypatch.setattr(sys, "meta_path", list(sys.meta_path))
    for module in (torch_import, jax_torch_import):
        monkeypatch.setattr(module, "_installed", False)
    for name in ("natten", "natten.functional"):
        if name in sys.modules:
            monkeypatch.setitem(sys.modules, name, sys.modules[name])
        else:
            monkeypatch.delitem(sys.modules, name, raising=False)
    yield
    for name in set(sys.modules) - before:
        if name.split(".")[0] in ("natten", *torch_import._STUB_ROOTS):
            del sys.modules[name]


def stand_in(install) -> T.Tuple[T.Any, T.Any]:
    install()
    natten = sys.modules.pop("natten")
    functional = sys.modules.pop("natten.functional")
    return natten, functional


@pytest.mark.parametrize(
    "height, width, heads, dim, kernel_size, dilation",
    [(10, 12, 2, 8, 3, 1), (9, 11, 2, 8, 3, 2), (14, 14, 4, 16, 7, 1)],
)
def test_natten_stand_in_matches_jax_and_the_port(
    restored_imports, height, width, heads, dim, kernel_size, dilation
):
    from cultionet_tpu_torch.ops.natten import neighborhood_attention_2d_ref

    port_natten, port_fn = stand_in(torch_import._install_torch_natten)
    jax_natten, jax_fn = stand_in(jax_torch_import._install_torch_natten)
    rng = np.random.default_rng(height + kernel_size)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, height, width, heads, dim))
                                .astype("float32")) for _ in range(3))
    args = (kernel_size, dilation)
    ours = port_fn.na2d(q, k, v, *args)
    torch.testing.assert_close(ours, jax_fn.na2d(q, k, v, *args), rtol=0, atol=1e-5)
    torch.testing.assert_close(
        ours, neighborhood_attention_2d_ref(q, k, v, *args), rtol=0, atol=0
    )
    torch.testing.assert_close(
        port_fn.na2d(q, k, v, *args, scale=0.3),
        jax_fn.na2d(q, k, v, *args, scale=0.3), rtol=0, atol=1e-5,
    )
    qn, kn, vn = (t.permute(0, 3, 1, 2, 4) for t in (q, k, v))
    logits = port_fn.na2d_qk(qn, kn, *args)
    torch.testing.assert_close(logits, jax_fn.na2d_qk(qn, kn, *args), rtol=0, atol=1e-5)
    weights = logits.softmax(-1)
    torch.testing.assert_close(
        port_fn.na2d_av(weights, vn, *args), jax_fn.na2d_av(weights, vn, *args),
        rtol=0, atol=1e-5,
    )
    channels = heads * dim
    torch.manual_seed(0)
    port_mod = port_natten.NeighborhoodAttention2D(channels, heads, kernel_size, dilation)
    jax_mod = jax_natten.NeighborhoodAttention2D(channels, heads, kernel_size, dilation)
    jax_mod.load_state_dict(port_mod.state_dict())
    x = torch.from_numpy(rng.normal(size=(2, height, width, channels)).astype("float32"))
    with torch.no_grad():
        torch.testing.assert_close(port_mod(x), jax_mod(x), rtol=0, atol=1e-5)


def test_install_reference_stubs_is_idempotent(restored_imports, monkeypatch):
    import numpy

    monkeypatch.setattr(
        torch_import, "_STUB_ROOTS", ["numpy", "no_such_package_anywhere"]
    )
    paths = len(sys.meta_path)
    torch_import.install_reference_stubs()
    natten = sys.modules["natten"]
    finder = sys.meta_path[-1]
    torch_import.install_reference_stubs()
    assert len(sys.meta_path) == paths + 1
    assert sys.modules["natten"] is natten
    assert finder.roots == {"no_such_package_anywhere"}
    import no_such_package_anywhere.deeper as stub  # noqa: F401

    assert sys.modules["numpy"] is numpy
    assert finder.find_spec("numpy") is None


def test_install_reference_stubs_keeps_an_installed_natten(
    restored_imports, monkeypatch
):
    import types

    monkeypatch.setattr(torch_import, "_STUB_ROOTS", [])
    real = types.ModuleType("natten")
    real.NeighborhoodAttention2D = object
    sys.modules["natten"] = real
    torch_import.install_reference_stubs()
    assert sys.modules["natten"] is real


# -- against the reference model itself ---------------------------------


@pytest.mark.skipif(
    not torch_import.reference_available(),
    reason="reference package (jgrss/cultionet) not present",
)
def test_import_torch_against_the_reference_model(tmp_path):
    """The port's ``import-torch`` of a reference CultioNet's Lightning
    checkpoint predicts as the reference model does (the counterpart of
    ``tests/test_torch_parity.py::test_import_torch_cli_roundtrip``)."""
    from cultionet_tpu_torch.model import load_model
    from cultionet_tpu_torch.train.step import make_predict_step

    cultionet_ref = torch_import.load_reference_module("cultionet.models.cultionet")
    torch.manual_seed(1)
    kwargs = {k: v for k, v in HYPER.items() if k not in ("in_channels", "in_time")}
    tm = cultionet_ref.CultioNet(in_channels=3, in_time=6, **kwargs)
    tm.eval()
    ckpt = {
        "state_dict": {f"cultionet_model.{k}": v for k, v in tm.state_dict().items()},
        "hyper_parameters": HYPER,
    }
    torch.save(ckpt, tmp_path / "last.ckpt")
    project = tmp_path / "project"
    cli.main(["import-torch", "-p", str(project), "--torch-ckpt",
              str(tmp_path / "last.ckpt")], device="cpu")
    _, model = load_model(project / "ckpt" / "last_store", device="cpu")
    batch = create_batch(
        num_channels=3, num_time=6, height=16, width=16, batch_size=2,
        rng=np.random.default_rng(3),
    )
    got = make_predict_step(model, "fp32", torch.device("cpu"))(batch.x, None, None)
    with torch.no_grad():
        want = tm.mask_model(batch.x.permute(0, 4, 1, 2, 3), latlon_coords=None)
    for name in OUTPUTS:
        np.testing.assert_allclose(
            got[name].numpy()[..., 0], want[name].numpy()[:, 0], atol=5e-5,
            rtol=1e-3, err_msg=name,
        )
