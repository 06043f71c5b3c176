"""The port stands alone: no JAX, nothing of the reference package, and
entry points that default to CUDA without falling back to the CPU."""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.runtime import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                       re.MULTILINE)


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch.serving.synergy, repro_torch.serving."
            "server, repro_torch.bridge; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'repro.')) or m == 'repro']; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_scanner_catches_forbidden_imports():
    for line in ("import jax", "from jax import numpy", "import repro.models",
                 "from repro.serving import engine", "  from repro import x"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.models import M",
                 "import jaxlib_free_module"):
        assert not FORBIDDEN.search(line), line


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device().type == "cuda"
    assert resolve_device("cpu").type == "cpu"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs.synera_pair import tiny_pair
    from repro_torch.models import model as M
    slm, _ = tiny_pair(vocab=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(slm)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_cache(slm, 1, 8)
    assert M.init_cache(slm, 1, 8, device="cpu")["layers"]["k"].shape[1] == 1


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """Without CUDA the smoke test exits non-zero and prints no result;
    copied alone into an empty directory it does the same."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal path is not taken")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout
