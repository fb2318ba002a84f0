"""The PyTorch port imports no jax and no JAX-package module, and uses no
library kernel in place of its own (sdpa, torch.compile, triton)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "jiao_liao_speech_recognition_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_every_port_module_imports_without_jax():
    mods = _modules()
    assert len(mods) >= 20
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'orbax', 'transformers',\n"
        "             'jiao_liao_speech_recognition_tpu'):\n"
        "    sys.modules[name] = None  # any import of these now fails\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jiao_liao_speech_recognition_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("needle", [
    "scaled_dot_product_attention", "torch.compile", "import triton", "from triton",
    "import jax", "from jax",
    "import jiao_liao_speech_recognition_tpu", "from jiao_liao_speech_recognition_tpu",
    # the card's machine has no transformers: the HF import reads files itself
    "import transformers", "from transformers",
])
def test_port_sources_use_no_library_kernels(needle):
    sources = sorted(PKG.rglob("*.py")) + sorted((PKG / "csrc").glob("*.cu*"))
    sources.append(ROOT / "chip_smoke.py")
    code_hits = []
    for path in sources:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            body = line.split("#", 1)[0] if path.suffix == ".py" else line.split("//", 1)[0]
            if needle in body:
                code_hits.append(f"{path.relative_to(ROOT)}:{i}")
    assert not code_hits, code_hits


def test_kernel_sources_target_sm90a_only_through_nvcc():
    from jiao_liao_speech_recognition_torch import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    cus = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert cus == ["ctc_loss.cu", "decode_attention.cu", "flash_attention.cu", "head.cu",
                   "ln_gemm.cu", "log_mel_tf32.cu", "quant.cu", "w8a8_mlp.cu"]
    for p in _build.CSRC.glob("*.cu"):
        text = p.read_text()
        for name in ("cublas", "cudnn", "cutlass"):
            assert name not in text.lower(), (p.name, name)
    # every exported symbol is declared to ctypes
    exported = set()
    for p in _build.CSRC.glob("*.cu"):
        for line in p.read_text().splitlines():
            if line.startswith('extern "C" int '):
                exported.add(line.split()[3].split("(")[0])
    assert exported == set(_build.SIGNATURES)


@pytest.mark.parametrize("needle", [
    "import jax", "from jax",
    "import jiao_liao_speech_recognition_tpu", "from jiao_liao_speech_recognition_tpu",
])
def test_port_examples_import_no_jax(needle):
    scripts = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(scripts) >= 8
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in scripts
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if needle in line.split("#", 1)[0]]
    assert not hits, hits
