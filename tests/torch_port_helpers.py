"""Shared helpers of the tests that hold the PyTorch port
(``cultionet_tpu_torch``) against the JAX package."""

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for a test module that imports this fixture:
    the test runner's workers share the cores, and torch's thread pool
    (oneDNN's bf16 kernels most of all) then slows down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_variables(module, *args, seed: int = 0, **kwargs) -> dict:
    """Variables for the flax ``module`` (the shapes ``module.init`` would
    make, traced abstractly) filled from a numpy seed, as nested dicts of
    float32 arrays.

    Kernels are He-normal over fan-in and biases standard normal, as the
    JAX package initializes them; every other leaf is moved off its init
    value (norm scales, running means and variances, gammas), so a
    translation that drops or swaps one shows in the outputs. Running
    variances are drawn at or above their init value 1: below it BatchNorm
    amplifies, and a random network already amplifies fp32 round-off
    toward the 1e-4 tolerance of the model tests.
    """
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs)
    )

    def fill(collection: str, key: str, shape) -> np.ndarray:
        if collection == "batch_stats":
            if key == "var":
                return rng.uniform(1.0, 2.0, shape)
            return 0.1 * rng.normal(size=shape)
        if key == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(size=shape) * np.sqrt(2.0 / fan_in)
        if key == "bias":
            return rng.normal(size=shape)
        return rng.uniform(0.8, 1.2, shape)  # scales and gammas

    def visit(tree, collection: str) -> dict:
        return {
            key: visit(value, collection)
            if hasattr(value, "items")
            else fill(collection, key, value.shape).astype("float32")
            for key, value in tree.items()
        }

    return {c: visit(tree, c) for c, tree in shapes.items()}


def write_chip_files(
    root, num: int, seed: int, packed: bool, num_time: int = 6, size: int = 12
) -> None:
    """``num`` seeded chips (3 bands, labels, boundary distances, bounds)
    under ``root/processed`` as ``.npz`` files; with ``packed`` x and bdist
    are int16 x 10000, as the chip creator writes them."""
    from cultionet_tpu.data.synthetic import create_batch

    rng = np.random.default_rng(seed)
    for i in range(num):
        batch = create_batch(
            num_channels=3, num_time=num_time, height=size, width=size,
            rng=rng,
        )
        if packed:
            batch = batch.replace(
                x=np.round(np.asarray(batch.x) * 10000).astype("int16"),
                bdist=np.round(np.asarray(batch.bdist) * 10000).astype("int16"),
            )
        batch.to_file(root / "processed" / f"data_{i:03d}.npz")


def jax_transformer_model(hidden, in_time=6, size=44, dropout=0.2, seed=None):
    """The JAX CultioNet with the transformer temporal front end and its
    seeded variables (``seeded_variables``, seed ``hidden`` by default)."""
    import jax.numpy as jnp

    from cultionet_tpu.data.batch import Batch
    from cultionet_tpu.models import CultioNet

    model = CultioNet(
        in_time=in_time, hidden_channels=hidden, dilations=[1, 2],
        dropout=dropout, temporal_encoder="transformer",
    )
    x = jnp.zeros((1, in_time, size, size, 3))
    variables = seeded_variables(
        model, Batch(x=x), training=False,
        seed=hidden if seed is None else seed,
    )
    return model, variables


def port_transformer_model(hidden, in_time=6, dropout=0.2):
    """The port's CultioNet of ``jax_transformer_model``'s configuration."""
    from cultionet_tpu_torch.models import CultioNet

    return CultioNet(
        in_time=in_time, hidden_channels=hidden, dilations=[1, 2],
        dropout=dropout, temporal_encoder="transformer",
    )


def restore_golden_checkpoint(ckpt_dir):
    """A trained golden checkpoint (``tests/data/golden*/ckpt/last_store``)
    restored as the JAX package's ``load_model`` restores it, through the
    converter's restore (``convert_orbax.py::restore_jax_checkpoint``).
    Returns the state and the JAX model."""
    from convert_orbax import restore_jax_checkpoint

    return restore_jax_checkpoint(ckpt_dir, "last")
