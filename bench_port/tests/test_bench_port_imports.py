"""What the benchmark loads: no JAX, no JAX package (compared by whole
top-level names, since the port's name begins with the JAX package's), a
reference that loads nothing of the program, and none of the JAX
package's benchmarks."""

from __future__ import annotations

import re
import subprocess
import sys

from .conftest import REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "vae_tagger_tpu")


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(REPO / "build")})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    loaded = _loaded_after(
        "import bench_port.run, bench_port.control\n"
        "from bench_port import spec\n"
        "for cell in ('flux1-dev.fp32.infer-b8', "
        "'flux1-dev.bf16.train_full-1024', 'flux1-dev.bf16.infer-b8'):\n"
        "    spec.load(cell).traffic()\n"
        "import vae_tagger_tpu_torch.infer.engine\n"
        "import vae_tagger_tpu_torch.train.steps\n"
        "import vae_tagger_tpu_torch.train.state\n")
    assert "vae_tagger_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import bench_port.reference.model\n"
                           "import bench_port.reference.train\n")
    assert "torch" in loaded
    assert not loaded & {"vae_tagger_tpu_torch", *FORBIDDEN}


def test_no_harness_file_imports_the_jax_side_or_its_benchmarks():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|"
                         r"vae_tagger_tpu|bench|benchmarks|chip_smoke)\b",
                         re.M)
    for path in (REPO / "bench_port").rglob("*.py"):
        assert not pattern.search(path.read_text()), path
