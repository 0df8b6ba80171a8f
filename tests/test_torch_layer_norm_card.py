"""The LayerNorm kernel (``cultionet_tpu_torch/ops/csrc/layer_norm_fwd.cu``)
on the card:

- against ``F.layer_norm`` on the same inputs at the transformer's predict
  rows (1,881,600 x 64) in bf16 and fp32, at a ragged row count, and at
  widths 256, 24, 36 and 4 (8-byte loads in bf16) and 6, 5 and 255 (4- and
  2-byte loads): bf16 within one bf16 ulp of the output's largest
  magnitude (the two sum in another order and each rounds once), fp32
  within 1e-5;
- the plan the library launches equals ``launch_plan``'s mirror at every
  width, and both refuse the same widths;
- a bf16 transformer ``CultioNet`` forward at (8, 12, 140, 140, 3) with
  the kernel against the same forward with ``layer_norm_rows`` sent to
  ``F.layer_norm``, both held to the fp32 forward: the kernel as near to
  it as the library;
- a fp32 transformer forward at ``hidden_channels`` 36 (not a multiple of
  8) with the kernel against the same forward through ``F.layer_norm``;
- ``LAUNCHES["layer_norm_rows"]``, and the counts of a root span around
  the forward, advance by 7 a forward; under a gradient it does not move,
  and the training kernels (``test_torch_layer_norm_train_card.py``)
  launch instead.

Needs a CUDA card; skipped without one. This file imports neither JAX nor
the JAX package, so it runs on a machine without them:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_layer_norm_card.py``.
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from chip_smoke import layer_norm_tolerance
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.models import temporal as temporal_module
from cultionet_tpu_torch.nn.dropout import dropout_rng
from cultionet_tpu_torch.nn.init import init_parameters_
from cultionet_tpu_torch.ops import layer_norm_cuda
from cultionet_tpu_torch.ops.layer_norm import layer_norm_rows
from cultionet_tpu_torch.utils import profiling


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run these tests on a machine with one")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize(
    "rows,width,dtype",
    [
        (1_881_600, 64, torch.bfloat16),
        (1_881_600, 64, torch.float32),
        (100_003, 64, torch.bfloat16),
        (40_000, 256, torch.bfloat16),
        (40_000, 256, torch.float32),
        (9_999, 24, torch.bfloat16),
        (50_001, 36, torch.bfloat16),
        (50_001, 36, torch.float32),
        (20_000, 4, torch.bfloat16),
        (20_000, 4, torch.float32),
        (20_000, 6, torch.bfloat16),
        (20_000, 5, torch.bfloat16),
        (20_000, 5, torch.float32),
        (3_001, 255, torch.float32),
        (3_001, 2048, torch.bfloat16),
    ],
)
def test_kernel_matches_f_layer_norm(card, rows, width, dtype):
    gen = torch.Generator(device=card).manual_seed(rows + width)
    x = (torch.randn(rows, width, device=card, generator=gen) * 2 + 0.5).to(dtype)
    w = (1 + 0.2 * torch.randn(width, device=card, generator=gen)).to(dtype)
    b = (0.2 * torch.randn(width, device=card, generator=gen)).to(dtype)
    got = layer_norm_cuda.launch_layer_norm_rows(x, w, b, 1e-5)
    want = F.layer_norm(x, (width,), w, b, 1e-5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= layer_norm_tolerance(want, dtype), err


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 1000, 1_881_600])
def test_library_plan_equals_the_mirror(card, dtype, rows):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    itemsize = torch.empty((), dtype=dtype).element_size()
    for width in range(1, 2049):
        try:
            want = layer_norm_cuda.launch_plan(rows, width, itemsize, sms)
        except ValueError:
            with pytest.raises(ValueError):
                layer_norm_cuda.card_plan(dtype, rows, width, card)
            continue
        got = layer_norm_cuda.card_plan(dtype, rows, width, card)
        assert got == {k: getattr(want, k) for k in got}, width


def _model(card, hidden_channels=64, batchnorm_passes=4, size=140):
    """The CLI-default transformer model with seeded weights and BatchNorm
    statistics estimated by training-mode passes (as ``chip_smoke.py``'s
    ``build_model``: a random network left at its initial statistics
    amplifies rounding many times over), in fp32 on the card."""
    model = CultioNet(
        in_time=12, in_channels=3, hidden_channels=hidden_channels,
        dilations=[1, 2],
        dropout=0.2, activation_type="SiLU", attention_weights="natten",
        temporal_encoder="transformer",
    )
    init_parameters_(model, torch.Generator().manual_seed(0))
    model.to(card).train()
    gen = torch.Generator(device=card).manual_seed(7)
    with torch.no_grad(), dropout_rng(gen):
        for _ in range(batchnorm_passes):
            model(torch.rand(8, 12, size, size, 3, device=card, generator=gen))
    return model.eval()


def _library_norms(monkeypatch):
    monkeypatch.setattr(
        temporal_module, "layer_norm_rows",
        lambda t, weight, bias, eps: F.layer_norm(t, (t.shape[-1],), weight, bias, eps),
    )


@pytest.mark.card
def test_transformer_forward_with_kernel(card, monkeypatch):
    """The bf16 model's seven LayerNorms through the kernel against the
    same forward through ``F.layer_norm``. Each LayerNorm may differ by one
    bf16 rounding, which the following bf16 layers carry: the two forwards
    lie up to 0.22 apart at single pixels of the distance head (measured on
    an H100). So both are held to the fp32 forward of the same weights: the
    kernel's mean gap within 10% of the library's (measured: 0.995-1.003
    times), its largest within twice the library's (0.81-0.93 times), and
    the two bf16 forwards nearer to each other than to fp32 (0.52-0.72
    times)."""
    model32 = _model(card)
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.rand(8, 12, 140, 140, 3, device=card, generator=gen)
    launches = layer_norm_cuda.LAUNCHES["layer_norm_rows"]
    profiling.enabled(True)
    try:
        with torch.inference_mode(), profiling.span("test.forward"):
            got = model16(x.to(torch.bfloat16))
        counted = profiling.totals()["test.forward"]["counts"]["layer_norm_rows"]
    finally:
        profiling.enabled(False)
        profiling.reset()
    assert counted == 7
    with torch.inference_mode():
        torch.cuda.synchronize()
        assert layer_norm_cuda.LAUNCHES["layer_norm_rows"] - launches == 7
        _library_norms(monkeypatch)
        want = model16(x.to(torch.bfloat16))
        ref = model32(x)
        torch.cuda.synchronize()
    assert layer_norm_cuda.LAUNCHES["layer_norm_rows"] - launches == 7
    for name in ("distance", "edge", "crop"):
        r = ref[name].float()
        kernel = (got[name].float() - r).abs()
        library = (want[name].float() - r).abs()
        between = (got[name].float() - want[name].float()).abs()
        gaps = [g.item() for g in (kernel.mean(), library.mean(), between.mean(),
                                   kernel.max(), library.max())]
        assert gaps[0] <= 1.1 * gaps[1], (name, gaps)
        assert gaps[2] <= gaps[1], (name, gaps)
        assert gaps[3] <= 2 * gaps[4], (name, gaps)


@pytest.mark.card
def test_transformer_forward_at_hidden_36(card, monkeypatch):
    """A width the 16-byte loads do not divide (36 channels: 8-byte loads
    in bf16, 16-byte in fp32) runs in the model, as near to the library's
    forward as the predict width's fp32 forward (``chip_smoke.py``'s
    ``model_transformer``: 1e-4). fp32 arithmetic in the convolutions and
    matmuls, as there: TF32 would round the two forwards' LayerNorm outputs
    (1e-6 apart) to values up to 2e-3 apart at the heads (measured on an
    H100)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model = _model(card, hidden_channels=36, batchnorm_passes=20, size=64)
    gen = torch.Generator(device=card).manual_seed(2)
    x = torch.rand(4, 12, 64, 64, 3, device=card, generator=gen)
    launches = layer_norm_cuda.LAUNCHES["layer_norm_rows"]
    with torch.inference_mode():
        got = model(x)
        torch.cuda.synchronize()
        assert layer_norm_cuda.LAUNCHES["layer_norm_rows"] - launches == 7
        half = copy.deepcopy(model).to(torch.bfloat16)(x.to(torch.bfloat16))
        torch.cuda.synchronize()
        assert layer_norm_cuda.LAUNCHES["layer_norm_rows"] - launches == 14
        _library_norms(monkeypatch)
        want = model(x)
    for name in ("distance", "edge", "crop"):
        assert torch.isfinite(half[name]).all()
        err = (got[name] - want[name]).abs().max().item()
        assert err <= 1e-4, (name, err)


@pytest.mark.card
@pytest.mark.parametrize("width,dtype", [(64, torch.float32), (128, torch.bfloat16)])
def test_gradient_launches_the_training_kernels(card, width, dtype):
    """Under a gradient the eval kernel does not launch; the training
    forward and the backward launch once each."""
    x = torch.randn(1000, width, device=card).to(dtype).requires_grad_()
    w = torch.ones(width, device=card, dtype=dtype)
    b = torch.zeros(width, device=card, dtype=dtype)
    launches = dict(layer_norm_cuda.LAUNCHES)
    out = layer_norm_rows(x, w, b, 1e-5)
    out.float().sum().backward()
    torch.cuda.synchronize()
    moved = {k: n - launches[k] for k, n in layer_norm_cuda.LAUNCHES.items()}
    assert moved == {"layer_norm_rows": 0, "layer_norm_rows_train": 1, "layer_norm_rows_bwd": 1}
    assert x.grad is not None
