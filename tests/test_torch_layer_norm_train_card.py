"""The LayerNorm training kernels (``cultionet_tpu_torch/ops/csrc/
layer_norm_fwd.cu``'s form with statistics and ``layer_norm_bwd.cu``) on
the card:

- the forward, dx, dweight and dbias of ``layer_norm_rows`` under a
  gradient against ``F.layer_norm`` with autograd on the same inputs, at
  TSViT's temporal rows (182,016 x 128), its spatial rows (43,776 x 128),
  the transformer front end's train rows (4 x 100^2 x 12 x 64), a ragged
  row count and widths 256, 36, 6, 5 and the widest, in bf16 and fp32: the
  forward and dx within #8's tolerances (fp32 1e-5; bf16 one ulp at the
  largest magnitude), dweight and dbias, sums over up to 480,000 rows,
  within one bf16 ulp, or in fp32 1e-5 of their largest magnitude (the two
  sum in another order); each row's mean and rstd within 1e-5 relative;
- two backward runs give the same bits;
- the backward's plan from the library equals ``launch_plan``'s mirror at
  every width, and both refuse the same widths;
- a captured and replayed CUDA graph of a TSViT forward and backward gives
  the eager step's gradients;
- a TSViT step launches each kernel 19 times (its 19 LayerNorms), and
  the transformer front end's 7 times.

Needs a CUDA card; skipped without one. This file imports neither JAX nor
the JAX package, so it runs on a machine without them:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_layer_norm_train_card.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from chip_smoke import layer_norm_tolerance
from cultionet_tpu_torch.models import TSViT
from cultionet_tpu_torch.models.temporal import TemporalTransformer
from cultionet_tpu_torch.ops import layer_norm_cuda
from cultionet_tpu_torch.ops.layer_norm import layer_norm_rows

TRAIN = ("layer_norm_rows_train", "layer_norm_rows_bwd")
BF16, FP32 = torch.bfloat16, torch.float32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run these tests on a machine with one")
    return torch.device("cuda:0")


def sum_tolerance(want, dtype) -> float:
    """A column sum over many rows: one bf16 ulp at the largest magnitude,
    or in fp32 1e-5 of it."""
    if dtype == torch.bfloat16:
        return layer_norm_tolerance(want, dtype)
    return 1e-5 * max(1.0, want.abs().max().item())


def inputs(card, rows, width, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(rows + width + seed)
    x = (torch.randn(rows, width, device=card, generator=gen) * 2 + 0.5).to(dtype)
    w = (1 + 0.2 * torch.randn(width, device=card, generator=gen)).to(dtype)
    b = (0.2 * torch.randn(width, device=card, generator=gen)).to(dtype)
    dy = torch.randn(rows, width, device=card, generator=gen).to(dtype)
    return x, w, b, dy


def gradients(fn, x, w, b, dy):
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, dy)
    return out.detach(), grads


@pytest.mark.card
@pytest.mark.parametrize(
    "rows,width,dtype",
    [
        (182_016, 128, BF16),  # TSViT's temporal rows at batch 16
        (182_016, 128, FP32),
        (43_776, 128, BF16),  # its spatial rows
        (43_776, 128, FP32),
        (480_000, 64, BF16),  # the transformer front end's train rows
        (480_000, 64, FP32),
        (100_003, 128, BF16),  # ragged
        (40_000, 256, BF16),
        (40_000, 256, FP32),
        (50_001, 36, BF16),  # 8-byte loads
        (50_001, 36, FP32),
        (20_000, 6, BF16),  # 4-byte loads
        (20_000, 6, FP32),
        (20_000, 5, BF16),  # 2-byte loads
        (20_000, 5, FP32),
        (3_001, 1024, FP32),  # 32 lanes x 8 chunks
        (3_001, 2048, BF16),
    ],
)
def test_training_kernels_match_f_layer_norm(card, rows, width, dtype):
    x, w, b, dy = inputs(card, rows, width, dtype)
    launches = {k: layer_norm_cuda.LAUNCHES[k] for k in TRAIN}
    got, got_grads = gradients(lambda *t: layer_norm_rows(*t, 1e-5), x, w, b, dy)
    want, want_grads = gradients(
        lambda x, w, b: F.layer_norm(x, (width,), w, b, 1e-5), x, w, b, dy
    )
    torch.cuda.synchronize()
    assert {k: layer_norm_cuda.LAUNCHES[k] - n for k, n in launches.items()} == {
        k: 1 for k in TRAIN
    }
    assert got.dtype == dtype and got.shape == x.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= layer_norm_tolerance(want, dtype), ("forward", err)
    for name, a, e, tol in zip(
        ("dx", "dweight", "dbias"), got_grads, want_grads,
        (layer_norm_tolerance, sum_tolerance, sum_tolerance),
    ):
        assert a.dtype == e.dtype and a.shape == e.shape, name
        err = (a.float() - e.float()).abs().max().item()
        assert err <= tol(e, dtype), (name, err, tol(e, dtype))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [BF16, FP32], ids=str)
def test_statistics_are_each_rows(card, dtype):
    x, w, b, _ = inputs(card, 43_776, 128, dtype)
    _, mean, rstd = layer_norm_cuda.launch_layer_norm_rows_train(x, w, b, 1e-5)
    xf = x.float()
    want_mean = xf.mean(-1)
    want_rstd = torch.rsqrt(xf.var(-1, unbiased=False) + 1e-5)
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == (43_776,)
    assert torch.allclose(mean, want_mean, rtol=1e-5, atol=1e-5)
    assert torch.allclose(rstd, want_rstd, rtol=1e-5, atol=0)


@pytest.mark.card
def test_backward_is_deterministic(card):
    x, w, b, dy = inputs(card, 182_016, 128, torch.bfloat16)
    out, mean, rstd = layer_norm_cuda.launch_layer_norm_rows_train(x, w, b, 1e-5)
    first = layer_norm_cuda.launch_layer_norm_rows_bwd(x, dy, mean, rstd, w)
    second = layer_norm_cuda.launch_layer_norm_rows_bwd(x, dy, mean, rstd, w)
    torch.cuda.synchronize()
    for name, a, e in zip(("dx", "dweight", "dbias"), first, second):
        assert torch.equal(a, e), name


@pytest.mark.card
@pytest.mark.parametrize("dtype", [FP32, BF16], ids=str)
@pytest.mark.parametrize("rows", [1, 1000, 182_016])
def test_library_backward_plan_equals_the_mirror(card, dtype, rows):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    itemsize = torch.empty((), dtype=dtype).element_size()
    for width in range(1, 2049):
        try:
            want = layer_norm_cuda.launch_plan(rows, width, itemsize, sms, backward=True)
        except ValueError:
            with pytest.raises(ValueError):
                layer_norm_cuda.card_plan(dtype, rows, width, card, backward=True)
            continue
        got = layer_norm_cuda.card_plan(dtype, rows, width, card, backward=True)
        assert got == {k: getattr(want, k) for k in got}, width


def tsvit_batch(card, batch=4, steps=20):
    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(batch, steps, 24, 24, 10, device=card, generator=gen)
    dates = torch.sort(torch.randint(0, 430, (batch, steps), device=card, generator=gen),
                       dim=1).values
    count = torch.full((batch,), steps, device=card)
    y = torch.randint(0, 19, (batch, 24, 24), device=card, generator=gen)
    return x.to(torch.bfloat16), dates, count, y


def tsvit_grads(model, batch):
    x, dates, count, y = batch
    model.zero_grad(set_to_none=False)
    logits = next(iter(model(x, dates=dates, date_count=count).values()))
    loss = F.cross_entropy(logits.float().permute(0, 3, 1, 2), y)
    loss.backward()
    return loss


@pytest.mark.card
def test_graphed_tsvit_step_gives_the_eager_gradients(card):
    """A TSViT forward and backward in bf16, captured as a CUDA graph and
    replayed, against the same step run eagerly on the same weights and
    batch. The LayerNorm kernels are deterministic; the gradients of the
    other kernels of the step may differ in their last bits."""
    torch.manual_seed(0)
    model = TSViT(in_channels=10).to(card).to(torch.bfloat16)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    batch = tsvit_batch(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            tsvit_grads(model, batch)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = {k: layer_norm_cuda.LAUNCHES[k] for k in TRAIN}
    with torch.cuda.graph(graph):
        loss = tsvit_grads(model, batch)
    assert {k: layer_norm_cuda.LAUNCHES[k] - n for k, n in launches.items()} == {
        k: 19 for k in TRAIN
    }
    for p in model.parameters():
        p.grad.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    graphed = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    eager_loss = tsvit_grads(model, batch)
    torch.cuda.synchronize()
    assert abs(loss.item() - eager_loss.item()) <= 1e-3 * abs(eager_loss.item())
    for name, p in model.named_parameters():
        want = p.grad.float()
        gap = (graphed[name] - want).norm().item()
        assert torch.isfinite(graphed[name]).all(), name
        assert gap <= 1e-2 * want.norm().item() + 1e-6, (name, gap)
    norms = {n: p for n, p in graphed.items() if "norm" in n or "mlp_head.0" in n}
    assert len(norms) == 2 * 19


@pytest.mark.card
def test_transformer_front_end_launches_seven_of_each(card):
    # Eval mode, so dropout draws nothing; the gradient still takes the
    # training kernels.
    model = TemporalTransformer(3, 64, 12, d_model=64, num_heads=4).to(card).eval()
    x = torch.rand(2, 12, 16, 16, 3, device=card)
    launches = {k: layer_norm_cuda.LAUNCHES[k] for k in TRAIN}
    model(x).float().sum().backward()
    torch.cuda.synchronize()
    assert {k: layer_norm_cuda.LAUNCHES[k] - n for k, n in launches.items()} == {
        k: 7 for k in TRAIN
    }
    assert all(p.grad is not None for p in model.parameters())
