"""Shared helpers of the tests that hold the PyTorch port
(``cultionet_tpu_torch``) against the JAX package."""

import jax
import numpy as np


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
