"""The tiles of the port's neighborhood-attention kernels
(cultionet_tpu_torch/ops/natten_cuda.py::_tile_plan and the halo functions
that csrc/na2d_common.cuh mirrors), checked on the CPU: every tile's halo
holds what its pixels read, the plan fits the card's shared memory, and a
NumPy emulation of the tiled forward and two-pass backward equals the plain
version and its autograd in fp64."""

import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from cultionet_tpu_torch.ops import natten as torch_natten
from cultionet_tpu_torch.ops import natten_cuda as nc

SHAPES = sorted(
    {
        (s[1], s[2], s[4], s[5], s[6])  # H, W, head_dim, kernel, dilation
        for s in chip_smoke.MODEL_SHAPES
        + chip_smoke.TRAIN_SHAPES
        + chip_smoke.EXTRA_SHAPES
    }
    | {
        (h, w, 32, k, d)
        for k, d in itertools.product((3, 5, 7), (1, 2, 3))
        for h, w in ((k * d, k * d + 1), (4 * k * d + 1, 3 * k * d + 2))
    }
)


def _cosets(length, dilation):
    """(coset, its length) of every coset along one axis."""
    return [
        (c, (length - c + dilation - 1) // dilation) for c in range(dilation)
    ]


def _axis_tiles(plan, axis, length, dilation):
    """(coset, coset length, p0, p1) of every tile along one axis that a
    block of the plan does not skip."""
    side, count = (plan.th, plan.tiles_h)
    if axis == 1:
        side, count = plan.tw, plan.tiles_w
    for c, clen in _cosets(length, dilation):
        for t in range(count):
            if t * side < clen:
                yield c, clen, t * side, min(t * side + side, clen)


@pytest.mark.parametrize("height,width,head_dim,ks,dil", SHAPES)
def test_tile_halos_hold_every_window(height, width, head_dim, ks, dil):
    """Query tiles: the key halo holds each query's window. Key tiles: the
    query halo holds every query whose window holds one of the tile's keys.
    Each halo stays within the plan's capacity."""
    for axis, length in ((0, height), (1, width)):
        idx = torch_natten._axis_neighbor_indices(length, ks, dil)
        for pass_ in nc.PASSES:
            plan = nc._tile_plan(height, width, ks, dil, head_dim, 2, pass_)
            side = plan.th if axis == 0 else plan.tw
            clen_max = -(-length // dil)
            reach = 2 * (ks - 1) if pass_ == "bwd_key" else ks - 1
            for c, clen, p0, p1 in _axis_tiles(plan, axis, length, dil):
                if pass_ == "bwd_key":
                    lo, hi = nc.query_halo(p0, p1, clen, ks)
                    keys = set(range(c + dil * p0, c + dil * p1, dil))
                    need = [
                        (i - c) // dil
                        for i in range(c, length, dil)
                        if keys & set(idx[i])
                    ]
                else:
                    lo, hi = nc.key_halo(p0, p1, clen, ks)
                    rows = idx[c + dil * p0 : c + dil * p1 : dil]
                    assert np.all((rows - c) % dil == 0)
                    need = ((rows - c) // dil).ravel().tolist()
                assert 0 <= lo and hi < clen
                assert lo <= min(need) and max(need) <= hi
                assert hi - lo + 1 <= min(clen_max, side + reach)


@pytest.mark.parametrize(
    "length,ks,dil",
    [
        (n, k, d)
        for n, k, d in itertools.product((7, 12, 35, 37), (3, 5, 7), (1, 2, 3))
        if n >= k * d
    ],
)
def test_window_start_steps_by_zero_or_one(length, ks, dil):
    """Along a coset the window start steps by 0 or 1 (what bounds a halo
    by the tile plus k - 1), and the member queries of each key are the
    interval [first_query, last_query]."""
    idx = torch_natten._axis_neighbor_indices(length, ks, dil)
    for c, clen in _cosets(length, dil):
        starts = [nc.coset_start(p, clen, ks) for p in range(clen)]
        assert starts == [(i - c) // dil for i in idx[c::dil, 0]]
        assert set(np.diff(starts)) <= {0, 1}
        for key in range(clen):
            members = [
                p for p in range(clen) if starts[p] <= key < starts[p] + ks
            ]
            assert members == list(_members(key, clen, ks))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_fits_shared_memory(itemsize):
    for (height, width, head_dim, ks, dil), pass_ in itertools.product(
        SHAPES, nc.PASSES
    ):
        vecs = [1] + [16 // itemsize] * (head_dim * itemsize % 16 == 0)
        for vec in vecs:
            plan = nc._tile_plan(
                height, width, ks, dil, head_dim, itemsize, pass_, vec
            )
            assert plan.smem <= nc.SMEM_BYTES == 232_448
            assert plan.threads <= 512 and plan.threads % 32 == 0
            assert plan.group * plan.chunks_per_lane * vec >= head_dim
            assert plan.pix >= head_dim and plan.pix % vec == 0
    with pytest.raises(ValueError, match="shared memory"):
        nc._tile_plan(200, 200, 13, 1, 512, 4, "bwd_key")
    with pytest.raises(ValueError, match="32 lanes"):
        nc._tile_plan(200, 200, 3, 1, 2048, 4, "fwd")


def test_vector_width_checks_every_pointer_and_stride():
    qkv = torch.zeros(1, 9, 9, 3 * 2 * 64)
    q, k, v = (t.unflatten(-1, (2, 64)) for t in qkv.chunk(3, -1))
    assert nc._vector_width(64, q, k, v) == 4
    odd = torch.zeros(1, 9, 9, 3 * 2 * 70)
    q, k, v = (t.unflatten(-1, (2, 70)) for t in odd.chunk(3, -1))
    assert nc._vector_width(70, q, k, v) == 1
    shifted = torch.zeros(1 + 9 * 9 * 2 * 64)[1:].view(1, 9, 9, 2, 64)
    assert nc._vector_width(64, shifted) == 1


def _coset_window(i, length, ks, dil):
    """Coset, coset length, position and window start of image index i."""
    c, p = i % dil, i // dil
    clen = (length - c + dil - 1) // dil
    return c, clen, p, nc.coset_start(p, clen, ks)


def _members(key, clen, ks):
    """The query positions whose window holds key position ``key``."""
    last = nc.last_query(key, clen, ks)
    return range(nc.first_query(key, clen, ks), last + 1)


def _emulate(q, k, v, g, ks, dil, mask):
    """The kernels' algebra in fp64, tile by tile: the forward and pass 1
    read keys from each query tile's halo and pass 1 writes (ds_j, w~_j)
    per slot; pass 2 gathers them per key of each key tile from its query
    halo, over the member queries [first_query, last_query]."""
    B, H, W, N, D = q.shape
    kk, scale = ks * ks, D**-0.5
    out, dq, dk, dv = (np.zeros_like(q) for _ in range(4))
    scratch = np.zeros((B, H, W, N, 2, kk))
    plan = nc._tile_plan(H, W, ks, dil, D, 4, "bwd_query")
    for (ch, _, h0, h1), (cw, _, w0, w1) in itertools.product(
        _axis_tiles(plan, 0, H, dil), _axis_tiles(plan, 1, W, dil)
    ):
        # The halo as the block holds it: coset rows a..b, columns c..d.
        a, b_ = nc.key_halo(h0, h1, (H - ch + dil - 1) // dil, ks)
        c, d = nc.key_halo(w0, w1, (W - cw + dil - 1) // dil, ks)
        rows = slice(ch + dil * a, ch + dil * b_ + 1, dil)
        cols = slice(cw + dil * c, cw + dil * d + 1, dil)
        kh, vh = k[:, rows, cols], v[:, rows, cols]
        for ph, pw in itertools.product(range(h0, h1), range(w0, w1)):
            h, w = ch + dil * ph, cw + dil * pw
            sh = _coset_window(h, H, ks, dil)[3]
            sw = _coset_window(w, W, ks, dil)[3]
            win = (slice(sh - a, sh - a + ks), slice(sw - c, sw - c + ks))
            kw = kh[:, win[0], win[1]].reshape(B, kk, N, D)
            vw = vh[:, win[0], win[1]].reshape(B, kk, N, D)
            logits = np.einsum("bnd,bjnd->bnj", q[:, h, w] * scale, kw)
            wts = np.exp(logits - logits.max(-1, keepdims=True))
            wts /= wts.sum(-1, keepdims=True)
            m = mask[:, h, w] if mask is not None else np.ones_like(wts)
            out[:, h, w] = np.einsum("bnj,bjnd->bnd", wts * m, vw)
            r = m * np.einsum("bnd,bjnd->bnj", g[:, h, w], vw)
            dl = wts * (r - (wts * r).sum(-1, keepdims=True))
            scratch[:, h, w, :, 0], scratch[:, h, w, :, 1] = dl, wts * m
            dq[:, h, w] = scale * np.einsum("bnj,bjnd->bnd", dl, kw)
    plan = nc._tile_plan(H, W, ks, dil, D, 4, "bwd_key")
    for (ch, clh, h0, h1), (cw, clw, w0, w1) in itertools.product(
        _axis_tiles(plan, 0, H, dil), _axis_tiles(plan, 1, W, dil)
    ):
        halo_h = nc.query_halo(h0, h1, clh, ks)
        halo_w = nc.query_halo(w0, w1, clw, ks)
        for kh_, kw_ in itertools.product(range(h0, h1), range(w0, w1)):
            key = (slice(None), ch + dil * kh_, cw + dil * kw_)
            for ph, pw in itertools.product(
                _members(kh_, clh, ks), _members(kw_, clw, ks)
            ):
                assert halo_h[0] <= ph <= halo_h[1]
                assert halo_w[0] <= pw <= halo_w[1]
                jh = kh_ - nc.coset_start(ph, clh, ks)
                j = jh * ks + kw_ - nc.coset_start(pw, clw, ks)
                qh, qw = ch + dil * ph, cw + dil * pw
                ds, wt = scratch[:, qh, qw, :, :, j].transpose(2, 0, 1)
                dk[key] += ds[..., None] * q[:, qh, qw] * scale
                dv[key] += wt[..., None] * g[:, qh, qw]
    return out, (dq, dk, dv)


@pytest.mark.parametrize(
    "shape,ks,dil",
    [
        ((2, 11, 13, 2, 4), 3, 2),
        ((1, 12, 11, 3, 4), 5, 1),
        ((1, 13, 14, 1, 2), 3, 3),
    ],
)
@pytest.mark.parametrize("drop", [False, True])
def test_emulated_kernels_match_plain_autograd(shape, ks, dil, drop):
    rng = np.random.default_rng(5)
    q, k, v, g = (rng.normal(size=shape) for _ in range(4))
    mask = None
    if drop:
        mask = torch_natten.dropout_keep_mask(11, (*shape[:4], ks * ks), 0.3)
        mask = mask.double().numpy()
    out, grads = _emulate(q, k, v, g, ks, dil, mask)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    weights_fn = None
    if mask is not None:
        weights_fn = lambda w: w * torch.from_numpy(mask)  # noqa: E731
    want = torch_natten.neighborhood_attention_2d(
        *leaves, ks, dil, weights_fn=weights_fn
    )
    want_grads = torch.autograd.grad(want, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(out, want.detach().numpy(), atol=1e-6, rtol=0)
    for got, ref in zip(grads, want_grads):
        np.testing.assert_allclose(got, ref.numpy(), atol=1e-6, rtol=0)
