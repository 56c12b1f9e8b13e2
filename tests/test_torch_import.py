"""The port imports torch and never jax or the JAX package."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "vae_tagger_tpu_torch"


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax():
    """In a fresh interpreter, importing every module of the port (the
    training modules included) leaves jax and the JAX package out of
    sys.modules."""
    assert {"vae_tagger_tpu_torch.train.train_full",
            "vae_tagger_tpu_torch.train.steps",
            "vae_tagger_tpu_torch.losses.combined",
            "vae_tagger_tpu_torch.data.loader"} <= set(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'vae_tagger_tpu' "
        "or m.startswith('vae_tagger_tpu.'))\n"
        "print('LOADED', len(sys.modules))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED" in proc.stdout


@pytest.mark.parametrize("pattern", [r"^\s*(import|from)\s+jax\b",
                                     r"vae_tagger_tpu\."])
def test_no_source_names_jax_or_the_jax_package(pattern):
    offenders = [str(p.relative_to(ROOT)) for p in sorted(PKG.rglob("*.py"))
                 if re.search(pattern, p.read_text(), re.MULTILINE)]
    assert not offenders, offenders


def test_cuda_sources_ship_as_package_data():
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu")) == [
        "flash_attention_bwd.cu", "flash_attention_bwd_tc.cu",
        "flash_attention_bwd_tf32x3.cu", "flash_attention_fwd.cu",
        "flash_attention_fwd_tc.cu", "flash_attention_fwd_tf32x3.cu",
        "gn_silu_conv3x3.cu", "gn_silu_conv3x3_tc.cu",
        "gn_silu_conv3x3_tf32x3.cu", "groupnorm_silu.cu",
        "groupnorm_silu_vec.cu"]
    text = (ROOT / "pyproject.toml").read_text()
    assert '"vae_tagger_tpu_torch"' in text and "csrc/*.cu" in text
