"""The benchmark's operation counts against a count taken by walking the
frozen reference's conv, linear and attention modules with hooks."""

from __future__ import annotations

import json

import pytest
import torch

from bench_port import arith
from bench_port.reference import model as reference
from bench_port.reference.tagger import MHSAOracle
from bench_port.reference.vae import AttentionBlock

from .conftest import REPO

CONFIG = json.loads((REPO / "bench_port/configs/flux1-dev.fp32.json")
                    .read_text())


def hook_count(config, height, width):
    """(encoder ops, head ops, conv_in ops, channel-gate ops) of one image,
    from the modules' output shapes on the meta device."""
    with torch.device("meta"):
        vae = reference.build_vae(config, False)
        head = reference.build_head(config)
    counts = {"enc": 0, "head": 0}

    def hook(part):
        def count(m, args, out):
            if isinstance(m, torch.nn.Conv2d):
                k = m.kernel_size[0] * m.kernel_size[1]
                ops = 2 * out.numel() * m.in_channels // m.groups * k
            elif isinstance(m, torch.nn.Linear):
                ops = 2 * out.numel() * m.in_features
            else:  # attention's two products: 4 S^2 C an image
                b, c, h, w = args[0].shape
                ops = 4 * b * (h * w) ** 2 * c
            counts[part] += ops
        return count

    for part, model in (("enc", vae.encoder), ("head", head)):
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear,
                              AttentionBlock, MHSAOracle)):
                m.register_forward_hook(hook(part))
    x = torch.empty(1, 3, height, width, device="meta")
    moments = vae.encoder(x)
    head(moments[:, :config["vae"]["latent_channels"]])
    gate = sum(2 * m.weight.numel() for m in
               head.spatial_attention.channel_att
               if isinstance(m, torch.nn.Conv2d)) * 2
    conv_in = 2 * height * width * vae.encoder.conv_in.weight.numel()
    return counts["enc"], counts["head"], conv_in, gate


@pytest.mark.parametrize("size", [(64, 64), (96, 64), (1024, 1024)])
def test_encode_tag_flops_equal_the_modules_count(size):
    enc, head, _, _ = hook_count(CONFIG, *size)
    assert arith.encode_tag_flops(CONFIG, *size) == enc + head


def test_train_step_flops_follow_the_forward_count():
    enc, head, conv_in, gate = hook_count(CONFIG, 64, 64)
    t = 8
    want = 3 * t * (3 * enc - conv_in) + t * (3 * head - gate)
    assert arith.train_full_step_flops(CONFIG, 64, 64, t) == want


def test_the_1024px_forward_is_4_88_tflop():
    assert abs(arith.encode_tag_flops(CONFIG, 1024, 1024) / 1e12
               - 4.8826) < 1e-3


def test_least_time_and_peaks():
    assert arith.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 495e12}
    f, b = arith.gn_silu_conv3x3(8, 128, 128, 512, 512, 512, False,
                                 "bfloat16")
    assert arith.least_seconds(f, b, "bfloat16") == f / 989e12
    f, b = arith.group_norm_silu_bwd(3, 1024, 1024, 128, "float32")
    assert arith.least_seconds(f, b, "float32") == b / 3.35e12
