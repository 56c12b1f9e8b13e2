"""The benchmark's own arithmetic: the card's peaks, and the operations and
bytes of each measured op, of an encode+tag forward and of a train_full
step, all counted from shapes.

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

def _conv(pixels, c_out, c_in, k):
    return 2 * pixels * c_out * c_in * k * k


def _down(n):
    """A side after the stride-2 3x3 conv on one extra row (column) of
    zeros: (n + 1 - 3) // 2 + 1."""
    return (n - 2) // 2 + 1


def _latent_side(vae, n):
    for _ in vae["block_out_channels"][1:]:
        n = _down(n)
    return n


def encoder_layers(vae: dict, height: int, width: int):
    """[(operations of one image's forward, whether the input needs a
    gradient)] of every conv, linear and attention product of the FLUX
    encoder (diffusers ``Encoder``) at ``height`` x ``width``."""
    boc = vae["block_out_channels"]
    layers = [(_conv(height * width, boc[0], vae["in_channels"], 3), False)]
    h, w, ch = height, width, boc[0]
    for i, out in enumerate(boc):
        for j in range(vae["layers_per_block"]):
            c_in = ch if j == 0 else out
            layers.append((_conv(h * w, out, c_in, 3), True))
            layers.append((_conv(h * w, out, out, 3), True))
            if c_in != out:
                layers.append((_conv(h * w, out, c_in, 1), True))
        ch = out
        if i < len(boc) - 1:
            h, w = _down(h), _down(w)
            layers.append((_conv(h * w, ch, ch, 3), True))
    for _ in range(2):
        layers += [(_conv(h * w, ch, ch, 3), True)] * 2
    if vae.get("mid_block_add_attention", True):
        s = h * w
        layers += [(2 * s * ch * ch, True)] * 4        # q, k, v, out
        layers.append((4 * s * s * ch, True))          # q k^T and p v
        # the second resnet follows the attention
    layers.append((_conv(h * w, 2 * vae["latent_channels"], ch, 3), True))
    return layers


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
        layers.append((_conv(lh * lw, 1, 2, 7), True))
    layers.append((_conv(lh * lw, c2, c, 3), head["use_spatial_attention"]))
    s = 64  # the adaptive pool's 8 x 8 tokens
    if head["use_self_attention"]:
        layers += [(2 * s * c2 * c2, True)] * 4
        layers.append((4 * s * s * c2, True))
    dims = [c2 * s, 1024, 512, 256, num_tags]
    layers += [(2 * a * b, True) for a, b in zip(dims, dims[1:])]
    return layers


def encode_tag_flops(config: dict, height: int, width: int) -> float:
    """Operations of one image's encode+tag forward."""
    vae = config["vae"]
    lh, lw = _latent_side(vae, height), _latent_side(vae, width)
    return float(sum(op for op, _ in encoder_layers(vae, height, width))
                 + sum(op for op, _ in head_layers(
                     config["head"], vae["latent_channels"], lh, lw,
                     config["num_tags"])))


def _train(layers):
    return sum(op * (3 if needs else 2) for op, needs in layers)


def train_full_step_flops(config: dict, height: int, width: int,
                          triplets: int) -> float:
    """Operations of one simplified-loss train_full step on ``triplets``
    (anchor, positive, negative) triplets: the encoder's forward and
    backward over all 3 x triplets images, the head's over the anchors."""
    vae = config["vae"]
    lh, lw = _latent_side(vae, height), _latent_side(vae, width)
    enc = _train(encoder_layers(vae, height, width))
    head = _train(head_layers(config["head"], vae["latent_channels"], lh, lw,
                              config["num_tags"]))
    return float(3 * triplets * enc + triplets * head)
