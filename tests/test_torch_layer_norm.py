"""The LayerNorm op of the port (cultionet_tpu_torch/ops/layer_norm.py) and
its kernel's launch plan (ops/layer_norm_cuda.py), checked on the CPU: the
registered op's CPU body is ``F.layer_norm``; a gradient takes
``F.layer_norm`` and inference the registered op; TemporalTransformer's
forward equals its ``nn.LayerNorm`` module path bit for bit with the same
``state_dict`` keys; the plan covers every row and chunk once; the wrapper
refuses what the kernel does not take; the backward's plan (the forward's
tiles over half the resident blocks, one (2, width) fp32 partial a block)
and the training wrappers' refusals. The kernels themselves run in
``test_torch_layer_norm_card.py`` and ``test_torch_layer_norm_train_card.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from cultionet_tpu_torch.models import temporal as temporal_module
from cultionet_tpu_torch.models.temporal import TemporalTransformer
from cultionet_tpu_torch.ops import layer_norm as ln
from cultionet_tpu_torch.ops import layer_norm_cuda as lnc
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(width, dtype, rows=37, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, 3, width, generator=g) * 2 + 0.5).to(dtype)
    w = (1 + 0.1 * torch.randn(width, generator=g)).to(dtype)
    b = (0.1 * torch.randn(width, generator=g)).to(dtype)
    return x, w, b


@pytest.mark.parametrize("width", [16, 64, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_body_equals_f_layer_norm(dtype, width):
    x, w, b = _inputs(width, DTYPES[dtype])
    want = F.layer_norm(x, (width,), w, b, 1e-5)
    with torch.inference_mode():
        got = torch.ops.cultionet_tpu_torch.layer_norm_rows(x, w, b, 1e-5)
    assert got.dtype == x.dtype and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_op_passes_opcheck():
    x, w, b = _inputs(64, torch.float32)
    torch.library.opcheck(ln.layer_norm_inference, (x, w, b, 1e-5))


def test_gradient_routes_to_f_layer_norm(monkeypatch):
    """Under a gradient the registered op is never called, and the
    gradients equal ``nn.LayerNorm``'s bit for bit."""

    def refuse(*args):
        raise AssertionError("the registered op ran under a gradient")

    monkeypatch.setattr(ln, "layer_norm_inference", refuse)
    module = nn.LayerNorm(64, eps=1e-5)
    with torch.no_grad():
        module.weight.normal_(1.0, 0.1)
        module.bias.normal_(0.0, 0.1)
    x, _, _ = _inputs(64, torch.float32)
    x1 = x.clone().requires_grad_(True)
    x2 = x.clone().requires_grad_(True)
    g = torch.randn_like(x)
    got = ln.layer_norm_rows(x1, module.weight, module.bias, module.eps)
    (got * g).sum().backward()
    grads = (x1.grad, module.weight.grad.clone(), module.bias.grad.clone())
    module.zero_grad()
    want = module(x2)
    (want * g).sum().backward()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, e in zip(grads, (x2.grad, module.weight.grad, module.bias.grad)):
        torch.testing.assert_close(a, e, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_inference_calls_the_registered_op(monkeypatch, mode):
    calls = []
    op = ln.layer_norm_inference

    def counted(*args):
        calls.append(args[0].shape)
        return op(*args)

    monkeypatch.setattr(ln, "layer_norm_inference", counted)
    module = nn.LayerNorm(64)  # parameters that require a gradient
    x, _, _ = _inputs(64, torch.float32)
    context = torch.inference_mode() if mode == "inference_mode" else torch.no_grad()
    with context:
        got = ln.layer_norm_rows(x, module.weight, module.bias, module.eps)
    assert calls == [x.shape]
    torch.testing.assert_close(got, module(x).detach(), rtol=0, atol=0)


def _transformer(seed=0):
    torch.manual_seed(seed)
    model = TemporalTransformer(3, 32, 6, d_model=32, num_heads=4).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.normal_(1.0, 0.2)
                m.bias.normal_(0.0, 0.2)
        model.pool_query.normal_(0.0, 0.5)
    return model


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_transformer_forward_equals_module_path(monkeypatch, dtype):
    """The forward through ``layer_norm_rows`` (the registered op, under
    inference) equals the same forward calling each ``LayerNorm_i``
    module, bit for bit, and runs the op once for each of its 7 norms."""
    model = _transformer().to(DTYPES[dtype])
    x = torch.rand(2, 6, 5, 4, 3).to(DTYPES[dtype])
    calls = []
    op = ln.layer_norm_inference

    def counted(*args):
        calls.append(args[0].shape)
        return op(*args)

    monkeypatch.setattr(ln, "layer_norm_inference", counted)
    with torch.inference_mode():
        got = model(x)
    assert len(calls) == 7
    by_weight = {
        id(m.weight): m for m in model.modules() if isinstance(m, nn.LayerNorm)
    }
    monkeypatch.setattr(
        temporal_module, "layer_norm_rows",
        lambda t, weight, bias, eps: by_weight[id(weight)](t),
    )
    with torch.inference_mode():
        want = model(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_transformer_state_dict_keys_unchanged():
    layers = 2
    want = {"pool_query"}
    want |= {f"Dense_{i}.{p}" for i in range(4 * layers + 5) for p in ("weight", "bias")}
    want |= {
        f"LayerNorm_{i}.{p}" for i in range(2 * layers + 3) for p in ("weight", "bias")
    }
    model = TemporalTransformer(3, 32, 6, d_model=32, num_layers=layers)
    assert set(model.state_dict()) == want
    assert all(
        isinstance(getattr(model, f"LayerNorm_{i}"), nn.LayerNorm)
        for i in range(2 * layers + 3)
    )


def _walk(plan):
    """Every (row, chunk) the plan's launch touches, with the kernel's
    indexing (``csrc/layer_norm_fwd.cu::layer_norm_rows_kernel``), the rows
    past the end and chunks past the width masked."""
    groups = 32 // plan.lanes
    warps = lnc.THREADS // 32
    lane = np.arange(32)
    warp, r, g = np.meshgrid(
        np.arange(warps), np.arange(plan.rows_per_thread), np.arange(groups),
        indexing="ij",
    )
    in_tile = (warp * plan.rows_per_thread * groups + r * groups + g).ravel()
    assert sorted(in_tile.tolist()) == list(range(plan.block_rows))
    rows = []
    for block in range(plan.grid):
        tiles = np.arange(block, plan.tiles, plan.grid)
        rows.append((tiles[:, None] * plan.block_rows + in_tile[None]).ravel())
    rows = np.concatenate(rows)
    chunk = (lane % plan.lanes)[:, None] + plan.lanes * np.arange(plan.cpl)[None]
    return rows[rows < plan.rows], chunk


@pytest.mark.parametrize(
    "rows,width,itemsize",
    [
        (1_881_600, 64, 2),  # the predict batch's token rows, bf16
        (156_800, 64, 4),
        (1_881_601, 64, 2),  # ragged
        (1, 64, 2),  # the pooling query
        (1000, 8, 2),
        (999, 24, 2),
        (77, 256, 2),
        (1234, 576, 4),
        (100, 1024, 2),
        (33, 1024, 4),
        (5000, 36, 2),  # 8-byte loads
        (5000, 36, 4),
        (700, 4, 2),
        (700, 6, 2),  # 4-byte loads
        (700, 5, 2),  # 2-byte loads
        (701, 255, 4),  # 4-byte loads, 8 chunks a lane
        (99, 2048, 2),
    ],
)
def test_launch_plan_covers_every_row_once(rows, width, itemsize):
    plan = lnc.launch_plan(rows, width, itemsize)
    covered, chunk = _walk(plan)
    assert np.array_equal(np.sort(covered), np.arange(rows))
    chunks = width // plan.vec
    assert plan.vec * itemsize <= 16 and width % plan.vec == 0
    held = chunk[chunk < chunks]
    assert np.array_equal(np.sort(np.unique(held)), np.arange(chunks))
    # Every lane group holds the whole row once.
    per_group = chunk[: plan.lanes].ravel()
    assert np.array_equal(np.sort(per_group[per_group < chunks]), np.arange(chunks))
    assert plan.lanes in (1, 2, 4, 8, 16, 32) and plan.cpl in (1, 2, 4, 8)
    assert plan.lanes == 32 or plan.cpl == 1
    assert plan.rows_per_thread * plan.cpl >= 4  # chunks in flight a thread
    assert 1 <= plan.grid <= 132 * plan.blocks_per_sm


def test_launch_plan_of_the_predict_rows():
    """D = 64 in bf16: 8 lanes a row, 4 rows a warp side by side, 4 rows a
    thread, a resident grid."""
    plan = lnc.launch_plan(1_881_600, 64, 2)
    assert (plan.vec, plan.lanes, plan.cpl, plan.rows_per_thread) == (8, 8, 1, 4)
    assert plan.block_rows == 128 and plan.grid == 528


@pytest.mark.parametrize(
    "width,itemsize,vec",
    [(64, 2, 8), (36, 2, 4), (36, 4, 4), (4, 2, 4), (6, 2, 2), (5, 2, 1),
     (6, 4, 2), (255, 4, 1), (2048, 2, 8), (1024, 4, 4)],
)
def test_launch_plan_takes_the_widest_load(width, itemsize, vec):
    """Each width takes the widest load, at most 16 bytes, that divides
    it, so every width of up to 256 loads runs: the transformer's every
    ``hidden_channels`` (a multiple of its 4 heads, at most 4 x 128)."""
    assert lnc.launch_plan(100, width, itemsize).vec == vec


@pytest.mark.parametrize(
    "case,error,match",
    [
        ("width 257", ValueError, "width 257"),
        ("width 1032", ValueError, "width 1032"),
        ("misaligned x", ValueError, "aligned"),
        ("float16", TypeError, "dtype"),
        ("mixed dtypes", TypeError, "dtype"),
        ("strided x", ValueError, "contiguous"),
        ("weight shape", ValueError, "last axis"),
        ("cpu tensors", ValueError, "CUDA device"),
    ],
)
def test_wrapper_refuses(case, error, match):
    width = {"width 257": 257, "width 1032": 1032}.get(case, 64)
    x, w, b = _inputs(width, torch.float32)
    if case == "misaligned x":  # one element past a 16-byte boundary
        x = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    if case == "float16":
        x, w, b = x.half(), w.half(), b.half()
    elif case == "mixed dtypes":
        x = x.bfloat16()
    elif case == "strided x":
        x = _inputs(128, torch.float32)[0][..., ::2]
    elif case == "weight shape":
        w = torch.ones(32)
    launches = lnc.LAUNCHES["layer_norm_rows"]
    with pytest.raises(error, match=match):
        lnc.launch_layer_norm_rows(x, w, b, 1e-5)
    assert lnc.LAUNCHES["layer_norm_rows"] == launches


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_gradient_equals_f_layer_norm(dtype):
    """On the CPU ``layer_norm_rows`` under a gradient is ``F.layer_norm``:
    the output and the gradients of x, the weight and the bias, bit for
    bit, in either type."""
    x, w, b = _inputs(128, DTYPES[dtype])
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(x.dtype)
    grads = []
    for fn in (ln.layer_norm_rows, lambda *t: F.layer_norm(t[0], (128,), *t[1:])):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        out = fn(*leaves, 1e-5)
        grads.append((out.detach(), *torch.autograd.grad(out, leaves, g)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "rows,width,itemsize", [(182_016, 128, 2), (43_776, 128, 2), (480_000, 64, 2),
                            (182_016, 128, 4), (1, 64, 2), (701, 255, 4), (99, 2048, 2)],
)
def test_backward_plan_covers_every_row_once(rows, width, itemsize):
    """The backward's plan is the forward's (so ``_walk`` covers every row
    and chunk once) on half the resident blocks: its grid, the number of
    (2, width) fp32 partials, is at most 132 x 2 blocks, or 132 from 2
    chunks a lane."""
    forward = lnc.launch_plan(rows, width, itemsize)
    plan = lnc.launch_plan(rows, width, itemsize, backward=True)
    keep = ("vec", "lanes", "cpl", "rows_per_thread", "block_rows", "tiles")
    assert all(getattr(plan, k) == getattr(forward, k) for k in keep)
    assert plan.blocks_per_sm == (2 if plan.cpl == 1 else 1)
    assert plan.grid == max(1, min(plan.tiles, 132 * plan.blocks_per_sm))
    covered, _ = _walk(plan)
    assert np.array_equal(np.sort(covered), np.arange(rows))


def test_backward_plan_of_tsvit_rows():
    """TSViT's temporal rows at width 128 in bf16: 16 lanes of 16 bytes a
    row, two rows a warp, 4 rows a thread; 264 blocks, so 264 x 2 x 128
    fp32 partials (270,336 bytes)."""
    plan = lnc.launch_plan(182_016, 128, 2, backward=True)
    assert (plan.vec, plan.lanes, plan.cpl, plan.rows_per_thread) == (8, 16, 1, 4)
    assert plan.block_rows == 64 and plan.tiles == 2844 and plan.grid == 264
    assert plan.grid * 2 * 128 * 4 == 270_336


@pytest.mark.parametrize("width,itemsize", [(257, 4), (1032, 4), (2056, 2), (0, 2)])
def test_backward_plan_refuses_the_forwards_widths(width, itemsize):
    with pytest.raises(ValueError, match=f"width {width}"):
        lnc.launch_plan(10, width, itemsize, backward=True)


@pytest.mark.parametrize(
    "case,error,match",
    [
        ("width 257", ValueError, "width 257"),
        ("float16", TypeError, "dtype"),
        ("cpu tensors", ValueError, "CUDA device"),
    ],
)
@pytest.mark.parametrize("wrapper", ["train", "bwd"])
def test_training_wrappers_refuse(case, error, match, wrapper):
    width = 257 if case == "width 257" else 64
    x, w, b = _inputs(width, torch.float32)
    if case == "float16":
        x, w, b = x.half(), w.half(), b.half()
    rows = x.numel() // width
    stats = torch.zeros(rows), torch.ones(rows)
    launches = dict(lnc.LAUNCHES)
    with pytest.raises(error, match=match):
        if wrapper == "train":
            lnc.launch_layer_norm_rows_train(x, w, b, 1e-5)
        else:
            lnc.launch_layer_norm_rows_bwd(x, torch.ones_like(x), *stats, w)
    assert lnc.LAUNCHES == launches
