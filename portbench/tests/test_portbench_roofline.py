"""roofline.py's counts against hand counts at one small shape a kernel."""

import pytest
import torch

from portbench import roofline


def test_na_counts():
    site = (2, 5, 6, 4, 8, 3, 1)  # B, H, W, heads, head_dim, kernel, dilation
    numel = 2 * 5 * 6 * 4 * 8
    slots = 2 * 5 * 6 * 4 * 9
    assert roofline.na_bytes_ops(site, 2, False) == (4 * numel * 2, slots * (4 * 8 + 3))
    assert roofline.na_bytes_ops(site, 4, True) == (7 * numel * 4, slots * (10 * 8 + 8))
    assert roofline.na_flops(site, False) == 4 * 8 * slots
    bytes_, ops = roofline.na_bytes_ops(site, 2, False)
    assert roofline.least_seconds(bytes_, ops, 2) == max(bytes_ / 3.35e12, ops / 989e12)


def test_temporal_counts():
    layer = (10, 12, 12, 64, 4, 10)  # N, Tq, S, C, heads, q rows
    pool = (10, 1, 12, 64, 4, 1)
    assert roofline.temporal_bytes_ops(layer, 2, False) == (
        (10 * 12 * 64 + 10 * 12 * 64 + 2 * 10 * 12 * 64) * 2, 4 * 10 * 12 * 12 * 64)
    assert roofline.temporal_bytes_ops(pool, 2, False)[0] == (64 + 10 * 64 + 2 * 10 * 12 * 64) * 2
    assert roofline.temporal_bytes_ops(layer, 4, True) == (
        (2 * 7680 + 7680 + 4 * 7680) * 4, 10 * 10 * 12 * 12 * 64)
    assert roofline.temporal_flops(layer, True) == 8 * 10 * 12 * 12 * 64


def test_layernorm_and_conv_counts():
    assert roofline.layernorm_bytes((7, 12, 64), 2) == 2 * 7 * 12 * 64 * 2
    from torch.utils.flop_counter import FlopCounterMode

    conv = torch.nn.Conv2d(3, 5, 3, padding=1)
    counter = FlopCounterMode(display=False)
    with counter:
        conv(torch.zeros(2, 3, 7, 9))
    assert counter.get_total_flops() == 2 * 2 * 7 * 9 * 5 * 3 * 9


@pytest.mark.parametrize("encoder", ["conv", "transformer"])
def test_model_sites(encoder):
    kwargs = dict(in_time=12, in_channels=3, hidden_channels=64, dropout=0.2,
                  dilations=[1, 2], attention_weights="natten", temporal_encoder=encoder)
    counts = roofline.count_model(kwargs, (8, 12, 140, 140, 3), backward=False)
    # The decoder's three NA sites (the fourth has a one-key window).
    assert counts.na_sites == [(8, 35, 35, 8, 32, 3, 1), (8, 70, 70, 4, 64, 3, 1),
                               (8, 140, 140, 4, 64, 3, 2)]
    if encoder == "transformer":
        n = 8 * 140 * 140
        assert counts.temporal_sites == [(n, 12, 12, 64, 4, n)] * 2 + [(n, 1, 12, 64, 4, 1)]
        assert counts.layernorm_shapes.count((n, 12, 64)) == 5
    else:
        assert counts.temporal_sites == []
    assert counts.flops() > counts.matmul_flops > 0
