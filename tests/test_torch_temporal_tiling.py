"""The tiles of the port's temporal-attention kernels
(cultionet_tpu_torch/ops/temporal_cuda.py::_tile_plan), checked on the CPU:
every plan of the card's calls fits a block's shared memory with its regions
disjoint and aligned, the persistent walk covers every pixel once, and a
NumPy emulation of the kernels' algebra (16-step chunks, the online softmax,
the backward's statistics sweep and its one writer per output; the pooling
path's softmax down each head's column) equals the plain version and its
autograd, in fp64 and with the bf16 roundings of the tensor-core paths."""

import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from cultionet_tpu_torch.ops import temporal_cuda as tc
from cultionet_tpu_torch.ops.temporal import temporal_attention_reference

ROWS = chip_smoke.TEMPORAL_ROWS + chip_smoke.TEMPORAL_EXTRA
CHUNK = 16


def _block_tiles(plan, n, block):
    """The pixels of each tile block ``block`` of a launch walks, in order
    (``temporal_common.cuh::walk_tiles``)."""
    return [
        range(t * plan.pixels, min(n, (t + 1) * plan.pixels))
        for t in range(block, plan.tiles, plan.grid)
    ]


def _plans(row):
    """(dtype name, backward, plan) of each launch the chip's check of
    ``row`` makes: q, k, v fused for a layer (Tq == S), the query broadcast
    for the pooling (Tq == 1)."""
    _, n, tq, s, c, heads = row
    for (name, itemsize), backward in itertools.product(
        (("float32", 4), ("bfloat16", 2)), (False, True)
    ):
        plan = tc._tile_plan(
            n, tq, s, c, heads, itemsize, backward,
            fused=tq == s, q_bcast=tq == 1,
        )
        yield name, itemsize, backward, plan


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_plan_fits_shared_memory_and_covers_the_row(row):
    _, n, tq, s, c, heads = row
    for _, itemsize, backward, plan in _plans(row):
        assert 0 < plan.smem <= tc.SMEM_BYTES == 232_448
        assert 1 <= plan.blocks_per_sm <= 8
        assert 1 <= plan.grid <= plan.tiles == -(-n // plan.pixels)
        assert plan.t_pad >= max(tq, s) and plan.t_pad % CHUNK == 0
        assert plan.hd_pad >= c // heads
        assert bool(plan.mma) == (itemsize == 2)
        pool = itemsize == 2 and tq == 1 and s <= CHUNK and heads <= 8
        assert bool(plan.pool) == (pool and c % 16 == 0)
        if plan.mma:
            assert plan.s_rows == -(-s // CHUNK) * CHUNK
            assert plan.tq_rows == (tq if plan.pool else -(-tq // CHUNK) * CHUNK)
        else:
            assert (plan.tq_rows, plan.s_rows) == (tq, s)
        assert len(plan.args) == 31


def _regions(plan, tq, s, itemsize, backward, heads):
    """(start, end) in bytes of every region one pixel's tile and the
    block's shared buffers use: the broadcast query, each stage's operand
    rows, each staged output and the warps' scratch."""
    size = lambda rows, rs, item=itemsize: rows * rs * item  # noqa: E731
    tq_rows, s_rows = plan.tq_rows, plan.s_rows
    out = []
    if plan.q_bcast:
        out.append((0, size(tq_rows, plan.rs_q)))
    if plan.pool:
        out.append((plan.qfrag_off, plan.stage0))
    for stage, p in itertools.product(range(plan.stages), range(plan.pixels)):
        base = plan.stage0 + stage * plan.stage_bytes + p * plan.pix_bytes
        if plan.fused:
            out.append((base, base + size(s_rows, plan.rs_kv)))
        else:
            if not plan.q_bcast:
                q = base + plan.q_off
                out.append((q, q + size(tq_rows, plan.rs_q)))
            for off in (plan.k_off, plan.v_off):
                out.append((base + off, base + off + size(s_rows, plan.rs_kv)))
        if backward:
            g = base + plan.g_off
            out.append((g, g + size(tq_rows, plan.rs_g)))
    for p in range(plan.pixels):
        base = plan.out0 + p * plan.out_pix_bytes
        if backward and plan.pool:
            out.append((base, base + size(tq, plan.rs_dq, 4)))
        elif backward:
            out.append((base, base + size(tq, plan.rs_dq, 4)))
            for off in (plan.dk_off, plan.dv_off):
                out.append((base + off, base + off + size(s, plan.rs_out)))
            stats = base + plan.stats_off
            out.append((stats, stats + tq * heads * 12))
        else:
            out.append((base, base + size(tq, plan.rs_out)))
    if plan.scratch_warp:
        out.append((plan.scratch0, plan.scratch0 + 8 * plan.scratch_warp))
    return out


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_plan_regions_are_disjoint_and_aligned(row):
    _, _, tq, s, c, heads = row
    for _, itemsize, backward, plan in _plans(row):
        regions = sorted(_regions(plan, tq, s, itemsize, backward, heads))
        assert all(a % 16 == 0 for a, _ in regions)
        if plan.pool:
            assert plan.qfrag_off + c // 16 * 32 * 8 == plan.stage0
        for (_, end), (start, _) in zip(regions, regions[1:]):
            assert end <= start
        assert regions[-1][1] <= plan.smem
        strides = [plan.rs_q, plan.rs_kv, plan.rs_g, plan.rs_out]
        # Odd numbers of 16-byte chunks: 8 rows fall in distinct banks.
        for rs, item in [(r, itemsize) for r in strides] + (
            [(plan.rs_dq, 4)] if backward else []
        ):
            assert rs * item % 32 == 16
        assert min(strides) >= c and plan.rs_kv >= (3 * c if plan.fused else c)


@pytest.mark.parametrize(
    "n,row", [(n, r) for r in ROWS for n in (1, 7, 37 * 41 + 5, r[1])]
)
def test_tiles_cover_every_pixel_once(n, row):
    _, _, tq, s, c, heads = row
    for sms in (132, 3):
        for backward, itemsize in itertools.product((False, True), (4, 2)):
            plan = tc._tile_plan(
                n, tq, s, c, heads, itemsize, backward, fused=tq == s,
                q_bcast=tq == 1, sms=sms,
            )
            seen = np.zeros(n, dtype=int)
            for block in range(plan.grid):
                for tile in _block_tiles(plan, n, block):
                    assert 0 < len(tile) <= plan.pixels
                    seen[tile.start:tile.stop] += 1
            assert (seen == 1).all()


def test_plan_raises_when_one_pixel_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        tc._tile_plan(4, 2000, 2000, 64, 4, 4, True)
    with pytest.raises(ValueError, match="Tq == S"):
        tc._tile_plan(4, 12, 10, 64, 4, 2, False, fused=True)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(
        torch.bfloat16
    ).double().numpy()


def _emulate(q, k, v, g, heads, rounding):
    """The kernels' algebra over (N, T, heads, head_dim) arrays: the
    forward's chunks of 16 query and 16 key steps with the online softmax
    and P rounded for O += P V; the backward's statistics sweep (max, 1 /
    denominator, delta online over the key chunks), then per key chunk over
    the query chunks P, dP and dS, dq accumulated over key chunks, dk and
    dv over query chunks. ``rounding`` rounds P and dS before the products
    and each output once (bf16 on the tensor cores; the identity for
    fp64)."""
    n, tq, c = q.shape
    s_len = k.shape[1]
    hd = c // heads
    scale = hd**-0.5
    q, g = (x.reshape(n, tq, heads, hd) for x in (q, g))
    k, v = (x.reshape(n, s_len, heads, hd) for x in (k, v))
    out = np.zeros_like(q)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    stats = np.zeros((n, tq, heads, 3))
    qchunks = [slice(a, min(a + CHUNK, tq)) for a in range(0, tq, CHUNK)]
    kchunks = [slice(a, min(a + CHUNK, s_len)) for a in range(0, s_len, CHUNK)]
    for qc in qchunks:
        m = np.full((n, heads, qc.stop - qc.start), -np.inf)
        den, dd = np.zeros_like(m), np.zeros_like(m)
        acc = np.zeros((n, heads, qc.stop - qc.start, hd))
        for kc in kchunks:
            logits = np.einsum("nthd,nshd->nhts", q[:, qc], k[:, kc]) * scale
            dp = np.einsum("nthd,nshd->nhts", g[:, qc], v[:, kc])
            new = np.maximum(m, logits.max(-1))
            corr = np.exp(m - new)
            p = np.exp(logits - new[..., None])
            m, den = new, den * corr + p.sum(-1)
            dd = dd * corr + (p * dp).sum(-1)
            acc = acc * corr[..., None] + np.einsum(
                "nhts,nshd->nhtd", rounding(p), v[:, kc]
            )
        out[:, qc] = (acc / den[..., None]).transpose(0, 2, 1, 3)
        stats[:, qc] = np.stack([m, 1 / den, dd / den], -1).transpose(
            0, 2, 1, 3
        )
    for kc in kchunks:
        for qc in qchunks:
            logits = np.einsum("nthd,nshd->nhts", q[:, qc], k[:, kc]) * scale
            dp = np.einsum("nthd,nshd->nhts", g[:, qc], v[:, kc])
            m, inv, delta = (
                stats[:, qc, :, i].transpose(0, 2, 1)[..., None]
                for i in range(3)
            )
            p = np.exp(logits - m) * inv
            ds = rounding(p * (dp - delta))
            dq[:, qc] += scale * np.einsum("nhts,nshd->nthd", ds, k[:, kc])
            dv[:, kc] += np.einsum("nhts,nthd->nshd", rounding(p), g[:, qc])
            dk[:, kc] += np.einsum("nhts,nthd->nshd", ds, q[:, qc])
    dk *= scale
    return [
        rounding(x).reshape(n, x.shape[1], c) for x in (out, dq, dk, dv)
    ]


def _emulate_pool(q, k, v, g, heads, rounding):
    """The pooling path's algebra (one query row for every pixel): P
    normalized, then rounded for O = P^T V and for dq = scale dS^T K; dk =
    scale dS q and dv = P g elementwise in full precision."""
    n, _, c = q.shape
    hd = c // heads
    scale = hd**-0.5
    qh, gh = (x.reshape(n, heads, hd) for x in (q[:, 0], g[:, 0]))
    kh, vh = (x.reshape(n, -1, heads, hd) for x in (k, v))
    logits = np.einsum("nhd,nshd->nhs", qh, kh) * scale
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("nhs,nshd->nhd", rounding(p), vh)
    dp = np.einsum("nhd,nshd->nhs", gh, vh)
    ds = p * (dp - (p * dp).sum(-1, keepdims=True))
    dq = scale * np.einsum("nhs,nshd->nhd", rounding(ds), kh)
    dk = scale * np.einsum("nhs,nhd->nshd", ds, qh)
    dv = np.einsum("nhs,nhd->nshd", p, gh)
    return [
        rounding(x).reshape(n, -1, c) for x in (out, dq, dk, dv)
    ]


def _kernel_algebra(row):
    """The emulation of the path the card's bf16 plan takes for ``row``."""
    _, n, tq, s, c, heads = row
    plan = tc._tile_plan(n, tq, s, c, heads, 2, False, q_bcast=tq == 1)
    return _emulate_pool if plan.pool else _emulate


def _plain(q, k, v, g, heads):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = temporal_attention_reference(*leaves, heads)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return [x.detach().double().numpy() for x in (out, *grads)]


def _inputs(row, n, seed, dtype):
    _, _, tq, s, c, _ = row
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1 if tq == 1 else n, tq, c))
    q = np.broadcast_to(q, (n, tq, c)).copy()
    k, v = (rng.normal(size=(n, s, c)) for _ in range(2))
    g = rng.normal(size=(n, tq, c))
    return [x.astype(dtype) for x in (q, k, v, g)]


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_emulated_kernels_match_plain_autograd(row):
    heads = row[5]
    q, k, v, g = _inputs(row, 5, 1, np.float64)
    got = _kernel_algebra(row)(q, k, v, g, heads, lambda x: x)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    # The plain version's algebra in fp64 (it computes in fp32).
    n, tq, c = q.shape
    hd = c // heads
    qh = leaves[0].reshape(n, tq, heads, hd) * hd**-0.5
    kh, vh = (x.reshape(n, -1, heads, hd) for x in leaves[1:])
    w = torch.softmax(torch.einsum("nthd,nshd->nhts", qh, kh), dim=-1)
    want = torch.einsum("nhts,nshd->nthd", w, vh).reshape(n, tq, c)
    grads = torch.autograd.grad(want, leaves, torch.from_numpy(g))
    for a, b in zip(got, [want.detach(), *grads]):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-6, rtol=0)
    plain = _plain(*(x.astype(np.float32) for x in (q, k, v, g)), heads)
    for a, b in zip(got, plain):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_emulated_bf16_kernels_stay_within_the_chip_gates(row):
    """bf16 inputs, P and dS rounded to bf16 before their products and each
    output rounded once, against the fp32 plain version on the same bf16
    inputs: the card's limits, 2e-2 (forward) and 5e-2 (gradients). The
    card checks the long query's backward in fp32 only."""
    heads = row[5]
    n = min(row[1], 64)
    q, k, v, g = (_bf16(x) for x in _inputs(row, n, 2, np.float32))
    got = _kernel_algebra(row)(q, k, v, g, heads, _bf16)
    plain = _plain(*(x.astype(np.float32) for x in (q, k, v, g)), heads)
    assert np.abs(got[0] - plain[0]).max() <= 2e-2
    if row[0] != "long_query":
        for a, b in zip(got[1:], plain[1:]):
            assert np.abs(a - b).max() <= 5e-2
