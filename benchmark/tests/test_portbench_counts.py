"""The yardstick's counts at known small shapes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark.reference import models

UNET = {"family": "mobilenetv2_unet", "num_classes": 10}


def test_lovasz_region_counts():
    got = counts.lovasz_region(1000, 10)
    assert got["bytes"] == 1000 * 10 * 4 * 2 + 1000 * 8
    assert got["ops"] == 1000 * 10 * counts.LOVASZ_OPS_PER_ELEMENT
    assert got["bound_s"] == pytest.approx(max(88000 / 3.35e12, 160000 / 67e12))


def test_mobilenetv2_encoder_is_the_published_300_million_macs():
    # MobileNetV2 1.0 at 224x224: 300 M multiply-adds, 1.28 M of them the
    # classifier that the encoder does not have
    with torch.device("meta"):
        enc = models.Encoder()
        x = torch.empty(1, 3, 224, 224)
    with FlopCounterMode(display=False) as fc:
        enc.eval()(x)
    assert 2 * 295e6 < fc.get_total_flops() < 2 * 302e6


def test_decoder_head_hand_count():
    full = counts.model_flops(UNET, 1, 64, 64, train=False)
    with torch.device("meta"):
        enc = models.Encoder()
        x = torch.empty(1, 3, 64, 64)
    with FlopCounterMode(display=False) as fc:
        enc.eval()(x)
    # up blocks (cin, cout, output side) and the head's two 1x1s at 32x32
    ups = [(1280 + 64, 256, 4), (256 + 32, 128, 8), (128 + 24, 64, 16), (64 + 16, 32, 32)]
    hand = sum(2 * 9 * s * s * (ci * co + co * co) for ci, co, s in ups)
    hand += 2 * 32 * 32 * (32 * 16 + 16 * 10)
    assert full - fc.get_total_flops() == hand


def test_scaling_with_batch_pixels_and_backward():
    one = counts.model_flops(UNET, 1, 64, 64, train=False)
    assert counts.model_flops(UNET, 2, 64, 64, train=False) == 2 * one
    assert counts.model_flops(UNET, 1, 128, 128, train=False) == 4 * one
    train = counts.model_flops(UNET, 1, 64, 64, train=True)
    assert train == 3 * one
