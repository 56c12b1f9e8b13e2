"""The plain reference of a ``train_full`` step with the simplified loss
(spawner1145/vae-tagger ``train_full.py``'s default), in fp32 with TF32
off, followed from the same initial weights over the same batches.

One step on B (anchor, positive, negative) triplets of uint8 pixels:

1. the 3B images, x / 127.5 - 1, through the encoder of the
   configuration's VAE family -> the moments -> mean and log-variance
   (clamped to [-30, 20]);
2. z = mean + exp(logvar / 2) * eps, eps standard normal from the step's
   generator, drawn for the whole (3B, h, w, C) stack in NHWC order;
3. the triplet term on the flattened z: cosine distance, hinge at the
   margin, each triplet weighted by 1 + 0.5 * overlap / anchor tag count;
4. the head, in training mode, on the anchors' means as the family
   transforms them for the head (FLUX: scaled and shifted), detached:
   BatchNorm on the batch's statistics (biased variance), and each dropout
   mask drawn from the same generator after eps, in the order the layers
   run (the self-attention's weights, then the classifier's three), as
   ``torch.rand(shape) >= p``, kept values scaled by 1 / (1 - p);
5. BCE with logits against the labels (mean), added to the triplet term
   with their weights;
6. the gradients clipped to a global norm, then AdamW (betas 0.9 / 0.999,
   eps 1e-8, decoupled weight decay) at the schedule's rate: linear warm-up
   from 0, then a cosine decay.

The step's generator is seeded as the trainer seeds it:
``(seed * 1_000_003 + step) mod 2**64``.  The encoder's gradient comes only
from the triplet term, which is a mean over triplets of per-triplet terms,
so the encoder runs one triplet at a time (its norms are per sample) and
the gradients add up; the head's BatchNorm couples the batch, so the head
runs on the whole batch.

Departures from the published description: the reference draws its own
dropout masks from an explicit generator rather than torch's global one,
so that another implementation can be held to the same masks; the
BatchNorm's running statistics are not followed (they do not enter a
training step's loss or gradients).  It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.nn.utils import parametrize

from bench_port import spec

from .model import build_head, build_vae, fp32_exact, fp8_round, part

MASK64 = 0xFFFFFFFFFFFFFFFF


def step_generator(device, seed: int, step: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(step)) & MASK64)
    return g


def lr_at(count: int, lr: float, warmup: int, total: int) -> float:
    """Linear warm-up 0 -> lr over ``warmup`` updates, then cosine to 0."""
    if count < warmup:
        return lr * count / warmup
    decay = max(1, max(total, warmup + 1) - warmup)
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, decay)
                                      / decay))


def _dropout(x, p, g):
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=g, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def head_train_forward(head, latents, g):
    """The attention head's forward in training mode, dropout from ``g``
    (``AttentionDecoderOracle.forward`` with explicit masks)."""
    x = latents
    if head.use_spatial:
        x = head.spatial_attention(x)
    conv, bn = head.feature_compress[0], head.feature_compress[1]
    x = conv(x)
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    x = (x - mean) / torch.sqrt(var + bn.eps) * bn.weight.view(1, -1, 1, 1) \
        + bn.bias.view(1, -1, 1, 1)
    x = F.adaptive_avg_pool2d(F.relu(x), (8, 8))
    if head.use_self:
        a = head.self_attention_post
        b, c, h, w = x.shape
        s = h * w
        seq = x.view(b, c, s).transpose(1, 2)
        y = a.norm(seq)

        def heads(t):
            return t.view(b, s, a.num_heads, a.head_dim).transpose(1, 2)

        q, k, v = heads(a.q_proj(y)), heads(a.k_proj(y)), heads(a.v_proj(y))
        weights = (q @ k.transpose(-2, -1) / math.sqrt(a.head_dim)).softmax(-1)
        weights = _dropout(weights, a.dropout.p, g)
        out = (weights @ v).transpose(1, 2).contiguous().view(b, s, c)
        x = (a.out_proj(out) + seq).transpose(1, 2).view(b, c, h, w)
    x = x.reshape(x.size(0), -1)
    for layer in head.classifier:
        x = _dropout(x, layer.p, g) if isinstance(layer, torch.nn.Dropout) \
            else layer(x)
    return x


def triplet_loss(za, zp, zn, la, lp, margin):
    a, p, n = (t.reshape(t.shape[0], -1) for t in (za, zp, zn))

    def dist(u, v):
        return 1.0 - (F.normalize(u, dim=1, eps=1e-12)
                      * F.normalize(v, dim=1, eps=1e-12)).sum(1)

    basic = (dist(a, p) - dist(a, n) + margin).clamp_min(0.0)
    weight = 1.0 + 0.5 * ((la * lp).sum(1) / (la.sum(1) + 1e-8))
    return basic * weight  # per triplet; the loss is their mean


class _Fp8(torch.nn.Module):
    """A weight rounded to float8 e4m3 on the way in, its gradient passed
    straight through."""

    def forward(self, w):
        return w + (fp8_round(w) - w).detach()


def _fp8_inputs(module, args):
    x = args[0]
    return (x + (fp8_round(x) - x).detach(),) + tuple(args[1:])


class TrainReference:
    """The reference's encoder and head and AdamW state, on ``device``, its
    parameters in fp32.  ``precision`` ``"bfloat16"`` computes under bf16
    autocast (the control of an fp32 configuration); ``"float8"`` also
    rounds the input and weight of every conv and linear layer to float8
    e4m3 (the control of a bf16 configuration)."""

    def __init__(self, config: dict, weights: dict, hp: dict, seed: int,
                 device, precision: str = "float32"):
        self.config, self.hp, self.seed, self.device = config, hp, seed, device
        self.precision = precision
        self.family = spec.family(config)
        with torch.device(device):
            vae, head = build_vae(config, False), build_head(config)
        vae.load_state_dict(part(weights, "vae"), strict=False)
        head.load_state_dict(part(weights, "head"))
        self.vae, self.head = vae, head
        self.params = {**{f"vae.{k}": p for k, p in vae.named_parameters()},
                       **{f"head.{k}": p for k, p in head.named_parameters()}}
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0
        if precision == "float8":
            for mod in (*vae.modules(), *head.modules()):
                if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                    parametrize.register_parametrization(mod, "weight",
                                                         _Fp8())
                    mod.register_forward_pre_hook(_fp8_inputs)

    def _x(self, px):
        return px.to(self.device).permute(0, 3, 1, 2).float() / 127.5 - 1.0

    def step(self, batch: dict, index: int) -> dict:
        """One step on a host batch (numpy); returns the loss, the clipped
        gradient's norm a leaf, the clip coefficient and the head's
        training-mode logits."""
        if self.precision == "float32":
            ctx = fp32_exact()
        else:  # fp32 parameters, bf16 compute
            ctx = torch.autocast(torch.device(self.device).type,
                                 dtype=torch.bfloat16)
        with ctx:
            return self._step(batch, index)

    def _step(self, batch, index):
        hp, fam = self.hp, self.family
        c = fam.latent_channels(self.config)
        g = step_generator(self.device, self.seed, index)
        anchor = torch.from_numpy(batch["anchor"])
        b = anchor.shape[0]
        lat = (fam.latent_side(self.config, anchor.shape[1]),
               fam.latent_side(self.config, anchor.shape[2]))
        eps = torch.randn((3 * b, *lat, c), generator=g, device=self.device,
                          dtype=torch.float32).permute(0, 3, 1, 2)
        la = torch.from_numpy(batch["labels"]).to(self.device).float()
        lp = torch.from_numpy(batch["positive_labels"]).to(self.device).float()
        for p in self.params.values():
            p.grad = None
        trip_sum, means = 0.0, []
        keys = ("anchor", "positive", "negative")
        for t in range(b):
            px = torch.stack([torch.from_numpy(batch[k][t]) for k in keys])
            moments = self.vae.encode_moments(self._x(px)).float()
            mean, logvar = moments[:, :c], moments[:, c:].clamp(-30.0, 20.0)
            z = mean + torch.exp(0.5 * logvar) * eps[[t, b + t, 2 * b + t]]
            per = triplet_loss(z[0:1], z[1:2], z[2:3], la[t:t + 1],
                               lp[t:t + 1], hp["triplet_margin"])
            (hp["triplet_weight"] * per.sum() / b).backward()
            trip_sum += float(per.sum().detach())
            means.append(mean[0:1].detach())
        latents = fam.head_latents(self.config, torch.cat(means))
        logits = head_train_forward(self.head, latents, g).float()
        bce = F.binary_cross_entropy_with_logits(logits, la)
        (hp["bce_weight"] * bce).backward()
        loss = (hp["triplet_weight"] * trip_sum / b
                + hp["bce_weight"] * float(bce.detach()))
        grads = {k: p.grad for k, p in self.params.items()
                 if p.grad is not None}
        total = torch.sqrt(sum(gr.square().sum() for gr in grads.values()))
        coef = min(1.0, hp["max_grad_norm"] / (float(total) + 1e-6))
        lr = lr_at(self.count, hp["learning_rate"], hp["lr_warmup_steps"],
                   hp["total_steps"])
        b1, b2, e, wd = 0.9, 0.999, 1e-8, hp["weight_decay"]
        self.count += 1
        norms = {}
        with torch.no_grad():
            for k, gr in grads.items():
                gr = gr * coef
                norms[k] = float(gr.norm())
                p = self.params[k]
                self.m[k].mul_(b1).add_(gr, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(gr, gr, value=1 - b2)
                denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.count)) \
                    .add_(e)
                p.mul_(1 - lr * wd)
                p.addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** self.count))
        return {"loss": loss, "grad_norms": norms, "clip": coef,
                "logits": logits.detach()}

    def change_norms(self, initial: dict) -> dict:
        """‖parameter - initial‖ a leaf."""
        with torch.no_grad():
            return {k: float((p - initial[k]).norm())
                    for k, p in self.params.items()}
