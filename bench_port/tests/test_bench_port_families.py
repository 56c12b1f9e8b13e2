"""VAE families found by file: the FLUX family reads as the harness read
before families were files (the same seeded weights, reference logits,
training-reference step and operation counts), a second family is taken
through ``spec.load``, the weights, the reference and ``arith`` by adding
files alone, and a family is refused where it is missing or where the
training reference cannot follow it."""

from __future__ import annotations

import hashlib
import json
import math
import re
import shutil
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from bench_port import inputs, spec, weights
from bench_port.reference import model as reference
from bench_port.reference.train import (
    TrainReference,
    head_train_forward,
    lr_at,
    step_generator,
    triplet_loss,
)
from bench_port.reference.vae import AutoencoderKLOracle

from .conftest import REPO

# sha256 of every leaf of weights.make(reference.shapes(cfg, with_decoder),
# 0, "cpu") in name order (name, then the fp32 bytes), taken at the commit
# before VAE families were files; both FLUX.1-dev configurations share it
WEIGHTS_SHA256 = {
    False: "1fb1620bd3d2d95f8c077c9785c5790572fee5d9d589c186afce184a09d14cfe",
    True: "e39487f18af7ef8e9306770c8ec8b98da402dd4a6c096ca7d6a6a90b1f69ed17",
}
CONFIGS = ("flux1-dev.fp32", "flux1-dev.bf16")
HP = {"learning_rate": 1e-4, "lr_warmup_steps": 1, "total_steps": 10,
      "weight_decay": 1e-6, "max_grad_norm": 1.0, "triplet_weight": 1.0,
      "bce_weight": 1.0, "triplet_margin": 1.0}


def _config(name="flux1-dev.fp32"):
    return json.loads((REPO / f"bench_port/configs/{name}.json").read_text())


def _tiny(class_name="AutoencoderKL"):
    cfg = _config()
    cfg["vae"].update(_class_name=class_name, norm_num_groups=4,
                      block_out_channels=[8, 16, 16, 16])
    cfg.update(name=f"tiny.{class_name}", num_tags=20)
    return cfg


def _sha256(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("with_decoder", [False, True])
@pytest.mark.parametrize("name", CONFIGS)
def test_the_seeded_weights_are_the_parents(name, with_decoder):
    cfg = _config(name)
    shapes = reference.shapes(cfg, with_decoder)
    assert _sha256(weights.make(shapes, 0, "cpu")) == \
        WEIGHTS_SHA256[with_decoder]
    assert _sha256(weights.make(shapes, 0, "cpu",
                                family=spec.family(cfg))) == \
        WEIGHTS_SHA256[with_decoder]


# ---------------------------------------------- the path before families

def _parent_vae(config):
    """reference/model.py's build_vae before families were files."""
    v = config["vae"]
    model = AutoencoderKLOracle(
        in_channels=v["in_channels"], out_channels=v["out_channels"],
        block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"],
        latent_channels=v["latent_channels"],
        norm_num_groups=v["norm_num_groups"],
        add_attention=v["mid_block_add_attention"],
        use_quant_conv=v["use_quant_conv"],
        use_post_quant_conv=v["use_post_quant_conv"])
    model.decoder = None
    model.post_quant_conv = None
    return model


@torch.no_grad()
def _parent_logits(config, w, px):
    """EncodeTag.logits in fp32 before families were files."""
    v = config["vae"]
    vae, head = _parent_vae(config), reference.build_head(config)
    vae.load_state_dict(reference.part(w, "vae"), strict=False)
    head.load_state_dict(reference.part(w, "head"))
    vae.eval()
    head.eval()
    x = px.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    mean = vae.encode_moments(x)[:, :v["latent_channels"]]
    return head(mean * v["scaling_factor"] + v["shift_factor"]).float()


class _ParentTrainReference(TrainReference):
    """TrainReference with its step as it was before families were files
    (fp32 only)."""

    def _step(self, batch, index):
        hp, v = self.hp, self.config["vae"]
        c = v["latent_channels"]
        g = step_generator(self.device, self.seed, index)
        anchor = torch.from_numpy(batch["anchor"])
        b = anchor.shape[0]
        f = 2 ** (len(v["block_out_channels"]) - 1)
        lat = anchor.shape[1] // f, anchor.shape[2] // f
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
        latents = torch.cat(means) * v["scaling_factor"] + v["shift_factor"]
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


def _train_batch(seed, triplets, res, num_tags):
    bank = inputs.image_bank(seed, 3 * triplets, res, res)
    labels = inputs.label_bank(seed, triplets, num_tags)
    return {"anchor": bank[:triplets], "positive": bank[triplets:2 * triplets],
            "negative": bank[2 * triplets:], "labels": labels,
            "positive_labels": labels[::-1].copy()}


def test_the_reference_vae_is_built_as_before():
    cfg = _tiny()
    with torch.device("meta"):
        vae, parent = reference.build_vae(cfg, False), _parent_vae(cfg)
    assert type(vae) is AutoencoderKLOracle
    assert {k: t.shape for k, t in vae.state_dict().items()} == \
        {k: t.shape for k, t in parent.state_dict().items()}
    assert vae.decoder is None and vae.post_quant_conv is None


def test_the_reference_logits_and_train_step_are_the_parents(two_threads):
    cfg = _tiny()
    w = weights.make(reference.shapes(cfg, True), 7, "cpu",
                     family=spec.family(cfg))
    px = torch.from_numpy(inputs.image_bank(7, 4, 64, 64))
    assert torch.equal(reference.EncodeTag(cfg, w, "cpu").logits(px),
                       _parent_logits(cfg, w, px))
    batch = _train_batch(7, 4, 64, cfg["num_tags"])
    new = TrainReference(cfg, w, HP, 7, "cpu")
    old = _ParentTrainReference(cfg, w, HP, 7, "cpu")
    for i in range(2):
        a, b = new.step(batch, i), old.step(batch, i)
        assert a["loss"] == b["loss"] and a["clip"] == b["clip"]
        assert a["grad_norms"] == b["grad_norms"]
        assert torch.equal(a["logits"], b["logits"])
    assert all(torch.equal(new.params[k], old.params[k]) for k in new.params)


def test_the_latent_side_is_the_parents():
    cfg = _tiny()
    fam = spec.family(cfg)
    for n in range(8, 300):
        assert fam.latent_side(cfg, n) == n // 8


# ------------------------------------------------- families added by files

def _checkout(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def _add_cell(root, cfg, base, name):
    """Adds ``cfg`` as a configuration file and a cell ``name`` with the
    traffic, limits and metrics of the cell ``base`` (data files and
    entries only)."""
    (root / f"bench_port/configs/{cfg['name']}.json").write_text(
        json.dumps(cfg))
    w = json.loads((root / f"bench_port/workloads/{base}.json").read_text())
    w.update(name=name, config=cfg["name"])
    w["params"].update(resolution=64, batch=2, bank_images=4,
                       check_images=2, triplets=2, host_batches=2)
    (root / f"bench_port/workloads/{name}.json").write_text(json.dumps(w))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(e for e in bench["workloads"] if e["name"] == base)
    bench["workloads"].append(dict(entry, name=name, config=cfg["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if base in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


INFER, TRAIN = "flux1-dev.fp32.infer-b8", "flux1-dev.bf16.train_full-1024"

# run in the copy, so that its own bench_port is the harness
_READ = """
import hashlib, json, sys
import torch
torch.set_num_threads(2)
from bench_port import arith, inputs, spec, weights
from bench_port.reference import model as reference
from bench_port.reference.train import TrainReference

def sha(t):
    data = t.detach().contiguous().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()

out = {}
for cell in sys.argv[1:]:
    c = spec.load(cell)
    cfg = c.config
    w = weights.make(reference.shapes(cfg, True), 5, "cpu",
                     family=spec.family(cfg))
    px = torch.from_numpy(inputs.image_bank(5, 2, 64, 64))
    batch = {"anchor": inputs.image_bank(5, 2, 64, 64, 4),
             "positive": inputs.image_bank(5, 2, 64, 64, 5),
             "negative": inputs.image_bank(5, 2, 64, 64, 6),
             "labels": inputs.label_bank(5, 2, cfg["num_tags"]),
             "positive_labels": inputs.label_bank(5, 2, cfg["num_tags"], 3, 7)}
    step = TrainReference(cfg, w, c.params["train"], 5, "cpu").step(batch, 0)
    out[cell] = {
        "family_file": c.family().__file__,
        "weights": {k: sha(t) for k, t in w.items()},
        "logits": sha(reference.EncodeTag(cfg, w, "cpu").logits(px)),
        "train_loss": step["loss"], "train_logits": sha(step["logits"]),
        "encode_tag_flops": arith.encode_tag_flops(cfg, 1024, 768),
        "train_flops": arith.train_full_step_flops(cfg, 64, 96, 3)}
print(json.dumps(out))
"""


def test_a_family_added_as_a_file_reads_as_flux(tmp_path):
    root = _checkout(tmp_path)
    shutil.copy(root / "bench_port/families/AutoencoderKL.py",
                root / "bench_port/families/AutoencoderKLCopy.py")
    _add_cell(root, _tiny("AutoencoderKL"), TRAIN, "tiny.flux.train")
    _add_cell(root, _tiny("AutoencoderKLCopy"), TRAIN, "tiny.copy.train")
    out = subprocess.run(
        [sys.executable, "-c", _READ, "tiny.flux.train", "tiny.copy.train"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(root)})
    assert out.returncode == 0, out.stderr[-3000:]
    read = json.loads(out.stdout.strip().splitlines()[-1])
    flux, copy = read.pop("tiny.flux.train"), read.pop("tiny.copy.train")
    assert flux.pop("family_file") == str(
        root / "bench_port/families/AutoencoderKL.py")
    assert copy.pop("family_file") == str(
        root / "bench_port/families/AutoencoderKLCopy.py")
    assert copy == flux


def test_a_missing_family_is_refused_at_load(tmp_path):
    root = _checkout(tmp_path)
    _add_cell(root, _tiny("AutoencoderKLMissing"), INFER, "tiny.missing")
    with pytest.raises(FileNotFoundError,
                       match="families/AutoencoderKLMissing.py"):
        spec.load("tiny.missing", root)


def test_a_family_the_training_reference_cannot_follow(tmp_path):
    root = _checkout(tmp_path)
    text = (root / "bench_port/families/AutoencoderKL.py").read_text()
    assert "TRAIN_REFERENCE = True" in text
    (root / "bench_port/families/NoTrain.py").write_text(
        text.replace("TRAIN_REFERENCE = True", "TRAIN_REFERENCE = False"))
    cfg = _tiny("NoTrain")
    _add_cell(root, cfg, INFER, "tiny.notrain.infer")
    _add_cell(root, cfg, TRAIN, "tiny.notrain.train")
    assert spec.load("tiny.notrain.infer", root).family().TRAIN_REFERENCE \
        is False
    with pytest.raises(ValueError, match="'NoTrain'"):
        spec.load("tiny.notrain.train", root)


TOY = '''
from bench_port import weights


def weight_kind(name, shape):
    if name.endswith(".gamma"):  # an RMS norm's scale, (C, 1, 1, 1)
        return "scale"
    return weights.leaf_kind(name, shape)


def weight_fan_in(name, shape):
    if len(shape) == 5:  # a causal 3-D conv on one frame: the last tap
        return shape[1] * shape[3] * shape[4]
    return weights.fan_in(name, shape)
'''


def test_a_family_gives_its_own_leaf_kinds(tmp_path):
    (tmp_path / "bench_port/families").mkdir(parents=True)
    (tmp_path / "bench_port/families/Toy.py").write_text(TOY)
    toy = spec.family({"vae": {"_class_name": "Toy"}}, tmp_path)
    shapes = {"vae.norm.gamma": (256, 1, 1, 1),
              "vae.conv.weight": (64, 96, 3, 3, 3), "vae.conv.bias": (64,),
              "head.fc.weight": (32, 48), "head.fc.bias": (32,)}
    own = weights.make(shapes, 3, "cpu", family=toy)
    default = weights.make(shapes, 3, "cpu")
    gamma = own["vae.norm.gamma"]
    assert abs(float(gamma.mean()) - 1.0) < 0.03
    assert abs(float(gamma.std()) - 0.1) < 0.02
    assert abs(float(default["vae.norm.gamma"].mean())) < 0.02  # a shift
    std = float(own["vae.conv.weight"].std())
    assert abs(std * math.sqrt(96 * 9) - 1.0) < 0.03
    assert torch.allclose(own["vae.conv.weight"] * math.sqrt(96 * 9),
                          default["vae.conv.weight"] * math.sqrt(96 * 27))
    # the same draw of matrices; the scales' draw comes before the shifts'
    assert torch.equal(own["head.fc.weight"], default["head.fc.weight"])
    assert abs(float(own["vae.conv.bias"].std()) - 0.05) < 0.02


# the keys of config["vae"] that only a family file reads
FAMILY_KEYS = re.compile(
    r"""["'](block_out_channels|layers_per_block|norm_num_groups|"""
    r"""scaling_factor|shift_factor|latent_channels)["']|\bAutoencoderKL\b""")


def test_only_family_files_know_the_architecture():
    frozen = {REPO / "bench_port/reference/vae.py",
              REPO / "bench_port/reference/tagger.py"}
    for path in (REPO / "bench_port").rglob("*.py"):
        rel = path.relative_to(REPO / "bench_port").parts
        if rel[0] in ("families", "tests") or path in frozen:
            continue
        assert not FAMILY_KEYS.search(path.read_text()), path
