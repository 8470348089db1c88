"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax``, ``ml_dtypes`` or the JAX package
``repro``, and its entry points never fall back to the CPU on their own."""
import ast
import json
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
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{path.name} imports {mod}"


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.serving.vision, "
            "repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.core.quant.ptq, repro_torch.bridge, "
            "repro_torch.models.ssm_lm, repro_torch.kernels.selective_scan, "
            "repro_torch.serving.cluster, repro_torch.serving.autoscaler, "
            "repro_torch.serving.faults, repro_torch.serving.events, "
            "repro_torch.serving.replica, repro_torch.distributed.fault_tolerance, "
            "repro_torch.configs.gemma2_2b, repro_torch.configs.gemma_7b, "
            "repro_torch.configs.llama3_8b, repro_torch.serving.trace, "
            "repro_torch.serving.introspect, repro_torch.serving.metrics_server, "
            "repro_torch.serving.metrics, repro_torch.analysis.hw, "
            "repro_torch.kernels.ops, repro_torch.kernels.autotune, "
            "repro_torch.distributed.expert_parallel, "
            "repro_torch.launch.mesh, repro_torch.launch.train, repro_torch.train, "
            "repro_torch.optim, repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.kernels.autograd, repro_torch.models.hybrid, "
            "repro_torch.models.encdec, repro_torch.models.ssm, "
            "repro_torch.configs.zamba2_7b, repro_torch.configs.seamless_m4t_medium, "
            "repro_torch.configs.internvl2_26b, repro_torch.configs.nemotron_4_340b, "
            "repro_torch.configs.qwen3_moe_235b_a22b; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'repro' not in sys.modules, 'repro imported'; "
            "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes imported'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_training_slice_imports_without_jax_triton_or_nvcc(tmp_path):
    """The scan's backward, the sharding rules, the reparameterization and
    the pod-aware train step import with no ``nvcc`` on the PATH, load
    neither ``jax`` nor ``triton``, and build nothing."""
    from repro_torch.kernels import _build

    before = sorted(_build.BUILD_DIR.glob("*.so")) if _build.BUILD_DIR.exists() else []
    code = ("import sys, repro_torch.kernels.selective_scan as ss, "
            "repro_torch.distributed.sharding_rules, repro_torch.core.quant, "
            "repro_torch.core.quant.reparam, repro_torch.train.train_step, "
            "repro_torch.optim.compress, repro_torch.kernels.autograd; "
            "assert callable(ss.selective_scan_bwd); "
            "assert not {'jax', 'repro', 'triton'} & set(sys.modules), sys.modules.keys()")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    after = sorted(_build.BUILD_DIR.glob("*.so")) if _build.BUILD_DIR.exists() else []
    assert after == before


@pytest.mark.parametrize("replicas", [0, 2])
def test_launch_serve_writes_a_trace_and_metrics_on_the_cpu(tmp_path, replicas):
    """``python -m repro_torch.launch.serve --smoke --device cpu --trace-out
    ... --metrics-out ...`` (one engine, and a cluster of two; with the
    endpoint and the periodic writer on) writes a trace that validates, with
    every request's timeline, and Prometheus text with a step histogram of
    every program it ran."""
    from repro_torch.serving.trace import KIND_REQUEST, Span, validate_chrome_trace
    from repro_torch.serving.trace import validate_request_timelines

    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "olmoe-1b-7b", "--smoke",
         "--device", "cpu", "--requests", "4", "--new-tokens", "4", "--replicas", str(replicas),
         "--trace-out", str(trace), "--metrics-out", str(prom), "--metrics-port", "0",
         "--metrics-interval", "0.05"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(trace.read_text())
    assert validate_chrome_trace(doc) > 0
    spans = [Span(e["tid"] - 1 + 1000 * e["pid"], e["name"], KIND_REQUEST, e["ts"] / 1e6,
                  (e["ts"] + e["dur"]) / 1e6)
             for e in doc["traceEvents"] if e["ph"] == "X" and e["cat"] == KIND_REQUEST]
    assert validate_request_timelines(spans) == 4
    text = prom.read_text()
    steps = {line.split('"')[1] for line in text.splitlines()
             if line.startswith("repro_step_latency_seconds_count{")}
    assert any(k.startswith("serve/decode|") for k in steps)
    assert any(k.startswith("serve/packed_prefill|") for k in steps)
    assert "repro_program_mfu{" in text and "metrics endpoint: http://127.0.0.1:" in proc.stdout


def _entry_points():
    from repro_torch.configs import TRAIN_4K, smoke_config
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import (
        ViTClassifier,
        encdec,
        hybrid,
        init_model_params,
        ssm_lm,
        transformer,
    )
    from repro_torch.launch.train import main as train_main
    from repro_torch.optim import adamw, constant
    from repro_torch.serving import ServeEngine, ServingCluster, VisionEngine, replica_devices
    from repro_torch.train import Trainer, TrainerConfig, init_train_state

    cfg = smoke_config("m3vit-small")
    lm = smoke_config("olmoe-1b-7b")
    ssm = smoke_config("falcon-mamba-7b")
    dense = smoke_config("gemma2-2b")
    hyb = smoke_config("zamba2-7b")
    ed = smoke_config("seamless-m4t-medium")
    vlm = smoke_config("internvl2-26b")
    return {
        "init_model_params": lambda: init_model_params(cfg),
        "ViTClassifier": lambda: ViTClassifier(cfg),
        "VisionEngine": lambda: VisionEngine(
            cfg, init_model_params(cfg, device="cpu")),
        "init_model_params[lm]": lambda: init_model_params(lm),
        "ServeEngine": lambda: ServeEngine(lm, init_model_params(lm, device="cpu")),
        "init_cache": lambda: transformer.init_cache(lm, 2, 8),
        "launch.serve": lambda: serve_main(["--arch", "olmoe-1b-7b", "--smoke"]),
        "init_model_params[ssm]": lambda: init_model_params(ssm),
        "ServeEngine[ssm]": lambda: ServeEngine(ssm, init_model_params(ssm, device="cpu")),
        "init_cache[ssm]": lambda: ssm_lm.init_cache(ssm, 2, 8),
        "launch.serve[ssm]": lambda: serve_main(["--arch", "falcon-mamba-7b", "--smoke"]),
        "ServingCluster": lambda: ServingCluster(lm, init_model_params(lm, device="cpu"),
                                                 replicas=2, engine="lm"),
        "ServingCluster[vision]": lambda: ServingCluster(
            cfg, init_model_params(cfg, device="cpu"), replicas=2),
        "replica_devices": lambda: replica_devices(2),
        "launch.serve[replicas]": lambda: serve_main(["--arch", "olmoe-1b-7b", "--smoke",
                                                      "--replicas", "2"]),
        "ServeEngine[dense]": lambda: ServeEngine(dense, init_model_params(dense,
                                                                           device="cpu")),
        "init_cache[dense]": lambda: transformer.init_cache(dense, 2, 8),
        "launch.serve[dense]": lambda: serve_main(["--arch", "gemma2-2b", "--smoke"]),
        "init_model_params[hybrid]": lambda: init_model_params(hyb),
        "init_cache[hybrid]": lambda: hybrid.init_cache(hyb, 2, 8),
        "init_model_params[encdec]": lambda: init_model_params(ed),
        "init_cache[encdec]": lambda: encdec.init_cache(ed, 2, 8),
        "ServeEngine[vlm]": lambda: ServeEngine(vlm, init_model_params(vlm, device="cpu")),
        "launch.serve[vlm]": lambda: serve_main(["--arch", "internvl2-26b", "--smoke"]),
        "init_train_state": lambda: init_train_state(cfg, adamw(constant(1e-3))),
        "Trainer": lambda: Trainer(cfg, TRAIN_4K, None, TrainerConfig()),
        "launch.train": lambda: train_main(["--arch", "m3vit-small", "--smoke", "--steps", "1"]),
    }


@pytest.mark.parametrize("name", ["init_model_params", "ViTClassifier", "VisionEngine",
                                  "init_model_params[lm]", "ServeEngine", "init_cache",
                                  "launch.serve", "init_model_params[ssm]",
                                  "ServeEngine[ssm]", "init_cache[ssm]",
                                  "launch.serve[ssm]", "ServingCluster",
                                  "ServingCluster[vision]", "replica_devices",
                                  "launch.serve[replicas]", "ServeEngine[dense]",
                                  "init_cache[dense]", "launch.serve[dense]",
                                  "init_model_params[hybrid]", "init_cache[hybrid]",
                                  "init_model_params[encdec]", "init_cache[encdec]",
                                  "ServeEngine[vlm]", "launch.serve[vlm]",
                                  "init_train_state", "Trainer", "launch.train"])
def test_entry_points_default_to_the_card_and_refuse_without_one(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
