"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and its entry
points never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.serving.vision, "
            "repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.core.quant.ptq, repro_torch.bridge; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'repro' not in sys.modules, 'repro imported'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _entry_points():
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import ViTClassifier, init_model_params, transformer
    from repro_torch.serving import ServeEngine, VisionEngine

    cfg = smoke_config("m3vit-small")
    lm = smoke_config("olmoe-1b-7b")
    return {
        "init_model_params": lambda: init_model_params(cfg),
        "ViTClassifier": lambda: ViTClassifier(cfg),
        "VisionEngine": lambda: VisionEngine(
            cfg, init_model_params(cfg, device="cpu")),
        "init_model_params[lm]": lambda: init_model_params(lm),
        "ServeEngine": lambda: ServeEngine(lm, init_model_params(lm, device="cpu")),
        "init_cache": lambda: transformer.init_cache(lm, 2, 8),
        "launch.serve": lambda: serve_main(["--arch", "olmoe-1b-7b", "--smoke"]),
    }


@pytest.mark.parametrize("name", ["init_model_params", "ViTClassifier", "VisionEngine",
                                  "init_model_params[lm]", "ServeEngine", "init_cache",
                                  "launch.serve"])
def test_entry_points_default_to_the_card_and_refuse_without_one(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
