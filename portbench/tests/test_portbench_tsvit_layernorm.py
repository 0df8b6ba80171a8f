"""The TSViT cell's LayerNorm metrics on the CPU: the least time of a
step's 19 LayerNorms at the configuration's widths, and both readers on a
program with the training counters and on one without them."""

import json
import types

import pytest

from portbench.roofline_tsvit import count_tsvit
from portbench.testing import ROOT

CONFIG = json.loads((ROOT / "portbench" / "configs" / "tsvit-pastis24.json").read_text())


def _metric(name):
    from portbench.harness import ROOT as root, load_module

    return load_module(root / "portbench" / "metrics" / f"{name}.py", name.replace(".", "_"))


def test_layernorm_bound_of_the_step():
    """19 LayerNorms a step at published widths: the temporal encoder's 9
    over 16 x 144 x 79 token rows, the spatial encoder's 9 and the head's
    over 16 x 19 x 144; 2 + 3 bf16 tensors of 128 moved once, ~0.79 ms."""
    roofline = _metric("tsvit.layernorm_roofline.train")
    model = CONFIG["model"]
    assert roofline.layernorm_rows(model, 2304, 79) == [(182_016, 9), (43_776, 10)]
    least = roofline.step_least_seconds(model, 2304, 79)
    assert least == 5 * (182_016 * 9 + 43_776 * 10) * 128 * 2 / 3.35e12
    assert 0.79e-3 < least < 0.80e-3


class _Tracer:
    def __init__(self, seconds):
        self.seconds = seconds
        self.patterns = None

    def device_seconds(self, patterns):
        self.patterns = patterns
        return self.seconds


@pytest.mark.parametrize("counted", [True, False], ids=["program", "parent"])
def test_layernorm_metrics_read_the_counters(monkeypatch, counted):
    """Three ``train.step`` spans that each move the training forward and
    backward counters by 19 read 38 launches a step, and the roofline the
    three steps' least time over the kernels' device time; a program
    without the counters (the parent's) reads nothing."""
    from cultionet_tpu_torch.ops import layer_norm_cuda
    from cultionet_tpu_torch.utils import profiling

    roofline = _metric("tsvit.layernorm_roofline.train")
    launches = _metric("tsvit.layernorm_launches.train")
    table = {"layer_norm_rows": 0}
    if counted:
        table.update(layer_norm_rows_train=0, layer_norm_rows_bwd=0)
    monkeypatch.setattr(layer_norm_cuda, "LAUNCHES", table)
    profiling.reset()
    profiling.enabled(True)
    try:
        for _ in range(3):
            with profiling.span("train.step"):
                for name in ("layer_norm_rows_train", "layer_norm_rows_bwd"):
                    if name in table:
                        table[name] += 19
        counts = count_tsvit(CONFIG["model"], 16, 60)
        least = roofline.step_least_seconds(CONFIG["model"], 2304, 79)
        ctx = types.SimpleNamespace(counts=counts, config=CONFIG,
                                    tracer=_Tracer(6 * least))
        got = (roofline.read(ctx), launches.read(ctx))
    finally:
        profiling.enabled(False)
        profiling.reset()
    if counted:
        assert got[0] == pytest.approx(50.0) and got[1] == 38
        assert ctx.tracer.patterns == ["layer_norm", "LayerNorm", "GammaBeta"]
    else:
        assert got == (None, None)
