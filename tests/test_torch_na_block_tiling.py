"""The tiles of the fused NA block kernel (cultionet_tpu_torch/ops/
na_block_cuda.py::_tile_plan, and the block geometry csrc/na_block_fwd.cu
mirrors), checked on the CPU: the tiles cover every pixel once, each
query's clamped window lies in its tile's key rectangle, the plan fits the
card's shared memory in regions the kernel may share, and a NumPy
emulation of the one-launch kernel (tiles, the halo's k and v recomputed
per tile, heads in passes over the laid-out weights) equals the reference
in fp64 and, with the kernel's bf16 roundings, stays within the chip's
fp32 gate against the plain version."""

import itertools
import math

import numpy as np
import pytest
import torch

import chip_smoke
from cultionet_tpu_torch.ops import na_block as port
from cultionet_tpu_torch.ops import na_block_cuda as nb
from cultionet_tpu_torch.ops import natten as torch_natten

# (H, W, C, heads, kernel, dilation, B)
SITES = sorted(
    {
        (h, w, c, heads, k, d, b)
        for b, h, w, c, heads, k, d in chip_smoke.NA_BLOCK_SITES
        + chip_smoke.NA_BLOCK_EXTRA
        + chip_smoke.NA_BLOCK_TRAIN_SITES
    }
    | {
        (h, w, c, heads, k, d, 2)
        for c, heads in ((16, 1), (40, 5), (64, 4), (256, 8), (512, 4))
        for k, d in itertools.product((1, 3), (1, 2, 3))
        for h, w in ((13, 11), (37, 35))
    }
)


def coset_len(length, coset, dilation):
    return (length - coset + dilation - 1) // dilation


def coset_start(p, clen, ks):
    return min(max(p - ks // 2, 0), clen - ks)


def blocks(plan, batch, height, width, ks, dilation):
    """Every block the kernel runs, in blockIdx order, as (b, ch, cw, p0h,
    nh, p0w, nw, h0, rows, w0, cols): its tile of coset positions and its
    key rectangle (na_block_fwd.cu)."""
    for b, ch, cw in itertools.product(
        range(batch), range(dilation), range(dilation)
    ):
        clen_h = coset_len(height, ch, dilation)
        clen_w = coset_len(width, cw, dilation)
        for th, tw in itertools.product(
            range(plan.tiles_h), range(plan.tiles_w)
        ):
            p0h, p0w = th * plan.th, tw * plan.tw
            if p0h >= clen_h or p0w >= clen_w:
                continue
            nh, nw = min(plan.th, clen_h - p0h), min(plan.tw, clen_w - p0w)
            h0, w0 = coset_start(p0h, clen_h, ks), coset_start(p0w, clen_w, ks)
            rows = coset_start(p0h + nh - 1, clen_h, ks) + ks - h0
            cols = coset_start(p0w + nw - 1, clen_w, ks) + ks - w0
            yield b, ch, cw, p0h, nh, p0w, nw, h0, rows, w0, cols


@pytest.mark.parametrize("height,width,channels,heads,ks,dil,batch", SITES)
def test_tiles_cover_each_pixel_once_and_hold_the_windows(
    height, width, channels, heads, ks, dil, batch
):
    plan = nb._tile_plan(height, width, ks, dil, channels, heads, 2, batch)
    count = np.zeros((dil * dil, height, width), int)
    rows_idx = torch_natten._axis_neighbor_indices(height, ks, dil)
    cols_idx = torch_natten._axis_neighbor_indices(width, ks, dil)
    for b, ch, cw, p0h, nh, p0w, nw, h0, rows, w0, cols in blocks(
        plan, 1, height, width, ks, dil
    ):
        assert rows * cols <= plan.cap
        assert 0 <= h0 and h0 + rows <= coset_len(height, ch, dil)
        assert 0 <= w0 and w0 + cols <= coset_len(width, cw, dil)
        ih = ch + dil * np.arange(p0h, p0h + nh)
        iw = cw + dil * np.arange(p0w, p0w + nw)
        count[ch * dil + cw][np.ix_(ih, iw)] += 1
        # The windows (plain NA's own neighbour indices) in coset positions.
        need_h = (rows_idx[ih] - ch) // dil
        need_w = (cols_idx[iw] - cw) // dil
        assert np.all((rows_idx[ih] - ch) % dil == 0)
        assert h0 <= need_h.min() and need_h.max() < h0 + rows
        assert w0 <= need_w.min() and need_w.max() < w0 + cols
    assert count.sum(0).min() == 1 and count.sum(0).max() == 1


def _region_ok(plan, channels, heads, itemsize):
    """na_block_fwd.cu::plan_fits: the regions the kernel keeps apart, and
    what its warp tiles and register arrays assume."""
    tile = plan.th * plan.tw
    assert all(
        off % 16 == 0
        for off in (
            plan.off_attn, plan.off_ln, plan.off_k, plan.off_v, plan.off_q,
            plan.off_x, plan.off_proj,
        )
    )
    assert plan.off_attn >= 3 * 32 * 264 * 2  # the weight ring
    assert plan.off_ln >= plan.off_attn + plan.tile_pad * plan.ld_attn * 2
    ln_end = plan.off_ln + plan.rows_pad * plan.ld_ln * 2
    assert plan.off_k >= ln_end and plan.off_x >= ln_end
    assert plan.off_v >= plan.off_k + plan.cap * plan.ld_kv * 4
    assert plan.off_q >= plan.off_v + plan.cap * plan.ld_kv * 4
    assert plan.off_proj >= plan.off_attn + plan.tile_pad * plan.ld_attn * 2
    assert plan.smem >= plan.off_q + tile * plan.ld_kv * 4
    assert plan.smem >= plan.off_x + plan.cap * channels * itemsize
    assert plan.smem >= plan.off_proj + plan.tile_pad * plan.ld_proj * 4
    assert plan.smem + 1024 <= nb.SMEM_BYTES  # with the static tables
    assert plan.rows_pad % 16 == 0 and 32 <= plan.rows_pad <= 128
    assert plan.cap <= plan.rows_pad
    assert plan.tile_pad in (32, 64) and tile <= plan.tile_pad
    assert plan.dp // 4 % plan.lanes == 0
    assert plan.lanes > 4 or plan.ld_kv % 32 == 16
    assert plan.dp // 4 // plan.lanes in (1, 2, 4)
    assert plan.group * plan.passes == heads and plan.p == plan.group * plan.dp


@pytest.mark.parametrize("height,width,channels,heads,ks,dil,batch", SITES)
def test_plan_fits_shared_memory(height, width, channels, heads, ks, dil, batch):
    for itemsize in (2, 4):
        plan = nb._tile_plan(
            height, width, ks, dil, channels, heads, itemsize, batch
        )
        _region_ok(plan, channels, heads, itemsize)
        assert plan.args[0] == plan.th and len(plan.args) == 24


def test_plan_sizes_and_refusal():
    """8 x 8 tiles at the decoder's 70^2 and 140^2 d2 sites in bf16; a tile
    that cannot fit raises."""
    for b, h, w, c, heads, k, d in chip_smoke.NA_BLOCK_SITES[1:]:
        plan = nb._tile_plan(h, w, k, d, c, heads, 2, b)
        assert (plan.th, plan.tw) == (8, 8) and plan.cap == 100
    assert nb._plan_for(8, 8, 140, 140, 3, 1, 512, 1, 4) is None
    assert nb._plan_for(16, 16, 140, 140, 3, 1, 64, 4, 2) is None  # > 64
    with pytest.raises(ValueError, match="no tile fits"):  # 4 KB elements
        nb._tile_plan(140, 140, 3, 1, 512, 1, 4096)


def bf16(a):
    """Round float32 values to bf16 (to nearest even), as float32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    return (x - mean) / np.sqrt(var + port.LN_EPS) * scale + bias


def emulate(x, params, heads, ks, dil, plan, rounding):
    """The kernel's walk over its blocks: LN1 of the key rectangle, per
    pass the rectangle times the pass's laid-out w_qkv (q, k, v for every
    rectangle pixel), the windows of the tile's queries in rectangle
    coordinates, the projection of the tile's attention rows, LN2. With
    ``rounding`` in fp32 with the kernel's bf16 roundings (weights, LN1,
    q.k products, attention); else in fp64 with none."""
    dtype = np.float32 if rounding else np.float64
    rnd = bf16 if rounding else (lambda a: a)
    prepared = nb.prepare_weights(
        params, heads, "cpu", torch.bfloat16 if rounding else torch.float64
    )
    prepared["w_qkv"], prepared["w_proj"] = nb.unpack_weights(
        prepared, x.shape[-1], heads
    )
    weights = {
        key: value.double().numpy().astype(dtype)
        for key, value in prepared.items()
    }
    batch, height, width, channels = x.shape
    head_dim = channels // heads
    cp = nb.padded_channels(channels)
    dp, p = plan.dp, plan.p
    # The kernel rounds head_dim^-0.5 once to fp32.
    scale = 1.0 / math.sqrt(head_dim)
    scale = np.float32(scale) if rounding else scale
    x = x.astype(dtype)
    out = np.full(x.shape, np.nan, dtype)
    for b, ch, cw, p0h, nh, p0w, nw, h0, rows, w0, cols in blocks(
        plan, batch, height, width, ks, dil
    ):
        ih = ch + dil * (h0 + np.arange(rows))
        iw = cw + dil * (w0 + np.arange(cols))
        xr = x[b][np.ix_(ih, iw)].reshape(rows * cols, channels)
        ln = rnd(layer_norm(xr, weights["ln1_scale"], weights["ln1_bias"]))
        ln = np.pad(ln, ((0, 0), (0, cp - channels)))
        qh, qw = np.arange(p0h, p0h + nh), np.arange(p0w, p0w + nw)
        clen_h, clen_w = coset_len(height, ch, dil), coset_len(width, cw, dil)
        sh = np.array([coset_start(i, clen_h, ks) for i in qh]) - h0
        sw = np.array([coset_start(i, clen_w, ks) for i in qw]) - w0
        base = (sh[:, None] * cols + sw[None, :]).ravel()
        window = np.array(
            [base + jh * cols + jw for jh in range(ks) for jw in range(ks)]
        ).T  # (queries, k^2) rectangle pixels
        own = ((qh - h0)[:, None] * cols + (qw - w0)[None, :]).ravel()
        attn = np.zeros((nh * nw, heads * dp), dtype)
        for ps in range(plan.passes):
            qkv = ln @ weights["w_qkv"][ps] + weights["b_qkv"][ps]
            q, k, v = qkv[own, :p] * scale, qkv[:, p : 2 * p], qkv[:, 2 * p :]
            for g in range(plan.group):
                hc = slice(g * dp, (g + 1) * dp)
                products = rnd(q[:, None, hc] * k[window][:, :, hc])
                logits = products.sum(-1)
                exps = np.exp(logits - logits.max(-1, keepdims=True))
                wts = exps * (dtype(1.0) / exps.sum(-1, keepdims=True))
                o = np.zeros((len(own), dp), dtype)
                for j in range(ks * ks):
                    o = o + wts[:, j, None] * v[window[:, j], hc]
                n = ps * plan.group + g
                attn[:, n * dp : (n + 1) * dp] = o
        proj = (rnd(attn) @ weights["w_proj"])[:, :channels] + weights["b_proj"]
        y = layer_norm(proj, weights["ln2_scale"], weights["ln2_bias"])
        oh = ch + dil * qh
        ow = cw + dil * qw
        out[b][np.ix_(oh, ow)] = y.reshape(nh, nw, channels)
    assert not np.isnan(out).any()
    return out


def _params(rng, channels, dtype=torch.float32):
    """chip_smoke's parameter scales: weights N(0, 1/C), LayerNorm scales
    N(1, 0.1), biases N(0, 0.1)."""
    params = {}
    for key in port.PARAM_KEYS:
        shape = {
            "w_qkv": (channels, 3 * channels),
            "b_qkv": (3 * channels,),
            "w_proj": (channels, channels),
        }.get(key, (channels,))
        value = rng.normal(size=shape)
        if key.startswith("w_"):
            value = value * channels**-0.5
        elif key.endswith("scale"):
            value = 1.0 + 0.1 * value
        else:
            value = 0.1 * value
        params[key] = torch.from_numpy(value).to(dtype)
    return params


def _plan(height, width, ks, dil, channels, heads, batch, tile):
    """The planner's plan for fp32 x, or the plan of a given tile."""
    if tile is None:
        return nb._tile_plan(height, width, ks, dil, channels, heads, 4, batch)
    return nb._plan_for(*tile, height, width, ks, dil, channels, heads, 4)


# (B, H, W, C, heads, kernel, dilation, given tile or None): the planner's
# own tiles, and small given tiles so that many blocks meet the borders.
EMULATED = [
    (1, 13, 11, 40, 5, 3, 2, None),
    (2, 12, 12, 64, 4, 3, 1, (4, 2)),
    (1, 11, 14, 48, 6, 3, 1, (2, 4)),
    (1, 9, 10, 24, 3, 1, 1, (2, 2)),
    (1, 16, 15, 32, 2, 3, 3, (1, 2)),
    (1, 10, 10, 32, 1, 3, 1, None),
]


@pytest.mark.parametrize("batch,height,width,channels,heads,ks,dil,tile", EMULATED)
def test_emulation_equals_reference_in_fp64(
    batch, height, width, channels, heads, ks, dil, tile
):
    rng = np.random.default_rng(7)
    params = _params(rng, channels, torch.float64)
    x = rng.normal(size=(batch, height, width, channels))
    plan = _plan(height, width, ks, dil, channels, heads, batch, tile)
    got = emulate(x, params, heads, ks, dil, plan, rounding=False)
    want = port.na_block_reference(
        torch.from_numpy(x), params, heads, ks, dil
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)


@pytest.mark.parametrize("batch,height,width,channels,heads,ks,dil,tile", EMULATED)
def test_emulation_with_roundings_within_the_fp32_gate(
    batch, height, width, channels, heads, ks, dil, tile
):
    """chip_smoke's fp32 gate for kernel #7 against the plain version:
    max-abs <= 2e-2 and at most 10% of the outputs above 1e-4."""
    rng = np.random.default_rng(8)
    params = _params(rng, channels)
    x = rng.normal(size=(batch, height, width, channels)).astype(np.float32)
    plan = _plan(height, width, ks, dil, channels, heads, batch, tile)
    got = emulate(x, params, heads, ks, dil, plan, rounding=True)
    want = port.na_block_plain(
        torch.from_numpy(x), params, heads, ks, dil
    ).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2e-2
    assert (diff > 1e-4).mean() <= 0.1
