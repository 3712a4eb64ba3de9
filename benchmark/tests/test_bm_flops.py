"""The operation and byte counts against hand counts of each layer."""

import pytest

from benchmark import flops

ARCH = {"positions": 33, "pileup_channels": 18, "lstm_units": [128, 160],
        "pileup_dense": 128, "head_dense": 128, "pileup_heads": 2,
        "conv_channels": [64, 128, 256], "pyramid_cells": [3, 2, 1], "fa_dense": 256}


def test_pileup_by_hand():
    lstm1 = 2 * 33 * (2 * 18 * 512 + 2 * 128 * 512)      # 9.87 M
    lstm2 = 2 * 33 * (2 * 256 * 640 + 2 * 160 * 640)     # 35.14 M
    dense = 2 * 10560 * 128                               # 2.70 M
    heads = 2 * (2 * 128 * 128) + 2 * 128 * 21 + 2 * 128 * 3
    got = flops.pileup(dict(ARCH, matrix_depth=55, fa_channels=8))
    assert got["flops_per_row"] == lstm1 + lstm2 + dense + heads
    assert got["flops_per_row"] == pytest.approx(47.79e6, rel=1e-3)
    assert got["bytes_per_row"] == 33 * 18 * 2 + 24 * 4
    assert got["weight_bytes"] == 2 * 2_072_216   # PileupNet's parameters


@pytest.mark.parametrize("depth,channels,want", [(55, 8, 272.8e6), (89, 9, 452.4e6)])
def test_full_alignment_by_hand(depth, channels, want):
    def conv(h, w, cin, cout):
        return 2 * h * w * cout * 9 * cin
    h1, w1 = (depth + 1) // 2, 17
    h2, w2 = (h1 + 1) // 2, 9
    h3, w3 = (h2 + 1) // 2, 5
    total = (conv(h1, w1, channels, 64) + 2 * conv(h1, w1, 64, 64)
             + conv(h2, w2, 64, 128) + 2 * conv(h2, w2, 128, 128)
             + conv(h3, w3, 128, 256) + 2 * conv(h3, w3, 256, 256)
             + 2 * 14 * 256 * 256
             + 4 * 2 * 256 * 128 + 2 * 128 * (21 + 3 + 33 + 33))
    got = flops.full_alignment(dict(ARCH, matrix_depth=depth, fa_channels=channels))
    assert got["flops_per_row"] == total
    assert got["flops_per_row"] == pytest.approx(want, rel=1e-3)
    assert got["bytes_per_row"] == depth * 33 * channels + 90 * 4


def test_weight_bytes_match_the_port_nets():
    from clair3_tpu_torch.models import FullAlignmentNet

    net = FullAlignmentNet(input_channels=8)
    n = sum(p.numel() for p in net.parameters()) + sum(b.numel() for b in net.buffers())
    assert flops.full_alignment(dict(ARCH, matrix_depth=55, fa_channels=8))["weight_bytes"] == 2 * n


def test_least_seconds_takes_the_larger_bound():
    c = {"flops_per_row": 1e9, "bytes_per_row": 1.0, "weight_bytes": 0.0}
    assert flops.least_seconds(989, 1, c) == pytest.approx(1e-3)
    c = {"flops_per_row": 1.0, "bytes_per_row": 3.35e9, "weight_bytes": 0.0}
    assert flops.least_seconds(1, 1, c) == pytest.approx(1e-3)
