"""The benchmark's own arithmetic: the card's peaks, and the operations and
bytes of each measured op, of an encode+tag forward and of a train_full
step, all counted from shapes.  The encoder's layers are the
configuration's VAE family's (``families/<_class_name>.py``); the head's,
the peaks and the per-op costs are here.

Peaks are NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s for bf16 on the
tensor cores, 495 TFLOP/s for fp32 operands (TF32's rate: the highest
tensor-core rate for fp32 inputs, so no fp32-accurate kernel can read more
than 100% of it; three TF32 products top out near a third), and 3.35 TB/s
of HBM3.

Operations count a multiply-add as 2 and take only convolutions, linear
layers and attention's two products; normalisations, activations, pooling
and the loss are left out (under 0.1% of a forward).  A backward counts
twice its forward (the input's and the weight's gradient) for every layer
whose input needs a gradient, once where only the weight's does (the first
conv of the encoder, whose input is pixels).  Recomputation (the flash
backward's scores, a checkpointed forward) is not counted.
"""

from __future__ import annotations

from bench_port import spec

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations over
    the peak for ``dtype`` and the bytes over the HBM bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


# ---------------------------------------------------------------- one op

def gn_silu_conv3x3(n, h, w, c_in, c_out, c_res=0, shortcut=False,
                    dtype="float32"):
    """(operations, bytes) of conv3x3(silu(gn(x))) + bias [+ residual, 1x1-
    projected when ``shortcut``] on NHWC x: x, the residual, the weights and
    the output each moved once."""
    it = ITEMSIZE[dtype]
    pixels = n * h * w
    flops = 2 * pixels * c_out * 9 * c_in
    if shortcut:
        flops += 2 * pixels * c_out * c_res
    nbytes = it * (pixels * (c_in + c_out + c_res)
                   + 9 * c_in * c_out + (c_res * c_out if shortcut else 0))
    return flops, nbytes


def flash_attention_fwd(b, sq, skv, d, dtype="float32"):
    """(operations, bytes) of softmax(q k^T / sqrt(d)) v: q, k, v and the
    output moved once, and the fp32 log-sum-exp written."""
    it = ITEMSIZE[dtype]
    return 4 * b * sq * skv * d, it * d * (2 * b * sq + 2 * b * skv) + 4 * b * sq


def group_norm_silu_bwd(n, h, w, c, dtype="float32"):
    """(operations, bytes) of the GroupNorm(+SiLU) backward: x and the
    upstream gradient read once and dx written once (its per-channel and
    per-group outputs are a few KB); elementwise, so bytes bound it."""
    it = ITEMSIZE[dtype]
    elems = n * h * w * c
    return 20 * elems, 3 * it * elems


# ---------------------------------------------------------------- models

def conv_ops(pixels, c_out, c_in, k):
    """Operations of a k x k conv over ``pixels`` output pixels."""
    return 2 * pixels * c_out * c_in * k * k


def head_layers(head: dict, latent_channels: int, lh: int, lw: int,
                num_tags: int):
    """[(operations of one image's forward, whether the input needs a
    gradient)] of the attention tagger head on (latent_channels, lh, lw)."""
    c, c2 = latent_channels, latent_channels // 2
    hidden = max(1, c // 8)
    layers = []
    if head["use_spatial_attention"]:
        # the channel gate's bottleneck on the pooled (detached) latents
        layers += [(2 * (hidden * c + c * hidden), False)] * 2  # avg, max
        layers.append((conv_ops(lh * lw, 1, 2, 7), True))
    layers.append((conv_ops(lh * lw, c2, c, 3), head["use_spatial_attention"]))
    s = 64  # the adaptive pool's 8 x 8 tokens
    if head["use_self_attention"]:
        layers += [(2 * s * c2 * c2, True)] * 4
        layers.append((4 * s * s * c2, True))
    dims = [c2 * s, 1024, 512, 256, num_tags]
    layers += [(2 * a * b, True) for a, b in zip(dims, dims[1:])]
    return layers


def _model(config: dict, height: int, width: int):
    """(encoder layers, head layers) of one image at ``height`` x ``width``;
    the encoder's from the configuration's VAE family."""
    fam = spec.family(config)
    lh = fam.latent_side(config, height)
    lw = fam.latent_side(config, width)
    return (fam.encoder_layers(config, height, width),
            head_layers(config["head"], fam.latent_channels(config), lh, lw,
                        config["num_tags"]))


def encode_tag_flops(config: dict, height: int, width: int) -> float:
    """Operations of one image's encode+tag forward."""
    enc, head = _model(config, height, width)
    return float(sum(op for op, _ in enc) + sum(op for op, _ in head))


def _train(layers):
    return sum(op * (3 if needs else 2) for op, needs in layers)


def train_full_step_flops(config: dict, height: int, width: int,
                          triplets: int) -> float:
    """Operations of one simplified-loss train_full step on ``triplets``
    (anchor, positive, negative) triplets: the encoder's forward and
    backward over all 3 x triplets images, the head's over the anchors."""
    enc, head = _model(config, height, width)
    return float(3 * triplets * _train(enc) + triplets * _train(head))
