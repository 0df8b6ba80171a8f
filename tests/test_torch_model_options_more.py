"""The model options O4-O6 (``--pool-by-max``, ``--batchnorm-first``,
``--use-latlon``, each with NATTEN) against the JAX package, with the
checks of ``test_torch_model_options.py`` (which holds O1-O3 and the
modules alone): strict translation, the eval forward in fp32 and bf16
with JAX's types at every segment, and one dropout-0 train step.

Also the dtype flow of ``use_latlon`` under bf16: JAX's step casts only
``x``, so the fp32 coordinate embedding makes the fusion towers and the
heads fp32; the port's tower outputs are fp32 as JAX's are, while the
encoder and the decoder stay bf16. ``pool_by_max`` halves an odd side to
its floor, which the decoder and the towers follow.
"""

import pytest

from test_torch_model_options import (  # noqa: F401 (fixture)
    build_option,
    check_eval_forward,
    check_train_step,
    check_translation,
    dtype_name,
    jax_eval_forward,
    one_torch_thread,
    port_eval_forward,
)

OPTIONS = {
    "pool_by_max": dict(pool_by_max=True),
    "batchnorm_first": dict(batchnorm_first=True),
    "use_latlon": dict(use_latlon=True),
}


@pytest.fixture(scope="module", params=list(OPTIONS))
def option(request):
    case = build_option(
        OPTIONS[request.param], seed=3 + list(OPTIONS).index(request.param)
    )
    case["name"] = request.param
    return case


def test_translation_is_strict(option):
    check_translation(option)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_matches_jax(option, dtype):
    check_eval_forward(option, dtype)


def test_train_step_matches_jax(option):
    check_train_step(option)


def test_bf16_dtype_flow(option):
    """Under bf16 the encoder and the decoder run in bf16; the towers and
    the outputs are fp32 under ``use_latlon`` only, in both packages."""
    latlon = option["name"] == "use_latlon"
    want, want_segments = jax_eval_forward(option, "bfloat16")
    got, segments = port_eval_forward(option, "bfloat16")
    expect = {
        "encoder": "bfloat16",
        "decoder": "bfloat16",
        "tower_fusion": "float32" if latlon else "bfloat16",
    }
    for segment, dtype in expect.items():
        for source in (segments, want_segments):
            assert {dtype_name(v) for v in source[segment].values()} == {
                dtype
            }, segment
    for name in ("distance", "edge", "crop"):
        assert dtype_name(got[name]) == dtype_name(want[name])
        assert dtype_name(got[name]) == (
            "float32" if latlon else "bfloat16"
        )
    sizes = {k: tuple(v.shape[-2:]) for k, v in segments["encoder"].items()}
    if option["name"] == "pool_by_max":
        assert sizes == {
            "x_a": (44, 44), "x_b": (22, 22), "x_c": (11, 11), "x_d": (5, 5)
        }
