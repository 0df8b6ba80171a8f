"""The port's CultioNet eval forward against the JAX model (its defaults,
packed paths on), the weight translator, and the port's import boundary."""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cultionet_tpu.data.batch import Batch
from cultionet_tpu.models import CultioNet as JaxCultioNet
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.utils.params import from_flax, load_flax

from torch_port_helpers import seeded_variables

OUTPUTS = ("distance", "edge", "crop")


def _jax_variables(hidden, in_time=6, size=44):
    model = JaxCultioNet(
        in_time=in_time, hidden_channels=hidden, dilations=[1, 2], dropout=0.2
    )
    x = jnp.zeros((1, in_time, size, size, 3))
    return model, seeded_variables(model, Batch(x=x), training=False, seed=hidden)


@pytest.mark.parametrize("hidden", [8, 16])
def test_eval_forward_matches_jax(hidden):
    jm, variables = _jax_variables(hidden)
    x = np.random.default_rng(hidden).random((2, 6, 44, 44, 3)).astype("float32")
    want = jax.jit(lambda v, x: jm.apply(v, Batch(x=x), training=False))(
        variables, jnp.asarray(x)
    )

    tm = CultioNet(in_time=6, hidden_channels=hidden, dilations=[1, 2], dropout=0.2)
    load_flax(tm, variables).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))

    assert set(got) == set(want)
    for name in OUTPUTS:
        assert got[name].shape == (2, 44, 44, 1)
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(want[name]), atol=1e-4, err_msg=name
        )
    for name in ("crop_type", "classes_l2", "classes_l3"):
        assert got[name] is None and want[name] is None


def test_translator_consumes_every_leaf():
    _, variables = _jax_variables(8)
    tm = CultioNet(in_time=6, hidden_channels=8, dilations=[1, 2])
    state = from_flax(variables)
    leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(state) == leaves
    # Every torch entry but BatchNorm's step counters comes from a leaf.
    torch_keys = {
        k for k in tm.state_dict() if not k.endswith("num_batches_tracked")
    }
    assert torch_keys == set(state)


def test_translator_names_unconsumed_leaves():
    _, variables = _jax_variables(8)
    variables["params"]["mask_model"]["stray"] = {"kernel": np.zeros((2, 2))}
    variables["batch_stats"]["extra_bn"] = {"mean": np.zeros(3)}
    tm = CultioNet(in_time=6, hidden_channels=8, dilations=[1, 2])
    with pytest.raises(ValueError) as err:
        load_flax(tm, variables)
    assert "mask_model.stray.weight" in str(err.value)
    assert "extra_bn.running_mean" in str(err.value)


def test_translator_refuses_missing_leaves():
    _, variables = _jax_variables(8)
    del variables["params"]["mask_model"]["final_combine"]["edge_gamma2"]
    tm = CultioNet(in_time=6, hidden_channels=8, dilations=[1, 2])
    with pytest.raises(RuntimeError, match="edge_gamma2"):
        load_flax(tm, variables)


def test_port_imports_no_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import cultionet_tpu_torch
        for info in pkgutil.walk_packages(
            cultionet_tpu_torch.__path__, "cultionet_tpu_torch."
        ):
            importlib.import_module(info.name)
        bad = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                   "cultionet_tpu", "cv2", "yaml")
        )
        assert not bad, bad
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_predict_entry_point_needs_cuda_by_default(monkeypatch):
    from cultionet_tpu_torch.predict import ScenePredictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = CultioNet(in_time=6, hidden_channels=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScenePredictor(model)


def test_model_predict_needs_cuda_by_default(monkeypatch):
    from cultionet_tpu_torch.model import predict

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = CultioNet(in_time=6, hidden_channels=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict(model, dataset=[])
