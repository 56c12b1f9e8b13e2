"""The plain reference of encode+tag, built from a configuration file and
given the benchmark's weights.

uint8 NHWC pixels -> x / 127.5 - 1 (NCHW) -> the encoder of the
configuration's VAE family (``bench_port/families/<_class_name>.py``) ->
the posterior mean (the first ``latent_channels`` of the moments) -> the
family's transform of it (FLUX: ``mean * scaling_factor + shift_factor``)
-> the attention tagger head in eval mode -> logits; probabilities are
their sigmoid.

``precision``:

- ``"float32"``: fp32 with TF32 off in cuBLAS and cuDNN (the reference);
- ``"bfloat16"``: every module and input in bf16, the control of an fp32
  configuration;
- ``"float8"``: bf16, and the input and weight of every conv and linear
  layer rounded to float8 e4m3 with a per-tensor scale (the largest
  magnitude to 448): the control of a bf16 configuration.

It imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch

from bench_port import spec

from .tagger import AttentionDecoderOracle

FP8_MAX = 448.0


def build_vae(config: dict, with_decoder: bool = True):
    """The family's plain reference VAE, with or without its decoder."""
    return spec.family(config).reference_vae(config, with_decoder)


def build_head(config: dict):
    h = config["head"]
    return AttentionDecoderOracle(
        spec.family(config).latent_channels(config), config["num_tags"],
        use_spatial=h["use_spatial_attention"],
        use_self=h["use_self_attention"], heads=h["attention_heads"],
        dropout=h["attention_dropout"])


def shapes(config: dict, with_decoder: bool = False) -> dict:
    """{state-dict name: shape} of the VAE (``vae.`` prefix) and the head
    (``head.``), without allocating them."""
    with torch.device("meta"):
        vae, head = build_vae(config, with_decoder), build_head(config)
    out = {f"vae.{k}": tuple(t.shape) for k, t in vae.state_dict().items()}
    out.update({f"head.{k}": tuple(t.shape)
                for k, t in head.state_dict().items()})
    return out


def part(weights: dict, prefix: str) -> dict:
    """The entries of ``weights`` under ``prefix.``, without it."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in weights.items() if k.startswith(prefix + ".")}


@contextlib.contextmanager
def fp32_exact():
    """TF32 off in cuBLAS and cuDNN for the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude to 448), in its own dtype."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn)
    return (q.float() * scale).to(t.dtype)


def _fp8_inputs(module, args):
    return (fp8_round(args[0]),) + tuple(args[1:])


class EncodeTag:
    """The reference's encode+tag over a batch of uint8 NHWC pixels, on
    ``device``, in ``precision``; the posterior mean is read from the
    reference VAE's ``encode_moments``."""

    def __init__(self, config: dict, weights: dict, device,
                 precision: str = "float32"):
        self.config, self.precision = config, precision
        self.family = spec.family(config)
        self.dtype = torch.float32 if precision == "float32" else torch.bfloat16
        with torch.device(device):
            vae, head = build_vae(config, False), build_head(config)
        vae.load_state_dict(part(weights, "vae"), strict=False)
        head.load_state_dict(part(weights, "head"))
        self.vae = vae.to(self.dtype).eval()
        self.head = head.to(self.dtype).eval()
        if precision == "float8":
            for m in (*self.vae.modules(), *self.head.modules()):
                if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                    with torch.no_grad():
                        m.weight.copy_(fp8_round(m.weight))
                    m.register_forward_pre_hook(_fp8_inputs)

    @torch.no_grad()
    def logits(self, pixels_uint8: torch.Tensor) -> torch.Tensor:
        """(B, num_tags) fp32 logits of (B, H, W, 3) uint8 pixels."""
        ctx = fp32_exact() if self.precision == "float32" else \
            contextlib.nullcontext()
        with ctx:
            x = pixels_uint8.permute(0, 3, 1, 2).to(self.dtype) / 127.5 - 1.0
            moments = self.vae.encode_moments(x)
            mean = moments[:, :self.family.latent_channels(self.config)]
            latents = self.family.head_latents(self.config, mean)
            return self.head(latents.to(self.dtype)).float()
