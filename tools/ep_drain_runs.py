#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s expert-parallel LM phase (``phase_ep_lm``) several
times in one process on one CUDA card, and record for each run whether its
EP cluster drained, the cluster's health (the eviction ledger, whose
verdicts carry the watchdog's inputs) and each replica's step times
replayed through the stall rule (``chip_smoke._StepTimer.replay``).

    python3 tools/ep_drain_runs.py [--runs 10] [--out build/ep_drain_runs.json]

Set-up, once: the kernels' build, full-width OLMoE-1B-7B's int8 and W4A8
trees (``chip_smoke._olmoe_trees``) and the single-path serve of the int8
tree (``chip_smoke._serve_lm``: the tokens every EP run is held to). A run
whose cluster does not drain raises in the phase; its message (the state
``run_until_idle`` prints) is recorded and the next run starts. Exits
non-zero when any run failed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "build" / "ep_drain_runs.json"))
    args = ap.parse_args()
    smi = c.phase_device()
    c.phase_build()
    t0 = time.perf_counter()
    _, params, qcfg, trees, _ = c._olmoe_trees()
    del params
    c._release()
    single = c._serve_lm(qcfg, trees["int8"], "int8", smi)
    print(f"[ep drain] set-up {time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for i in range(args.runs):
        t1 = time.perf_counter()
        try:
            ep = c.phase_ep_lm(qcfg, trees, single, smi)
        except AssertionError as e:
            runs.append({"run": i, "drained": False, "error": str(e)})
        else:
            runs.append({"run": i, "drained": True, "health": ep["cluster_health"],
                         "watchdog_steps": ep["watchdog_steps"]})
        runs[-1]["seconds"] = time.perf_counter() - t1
        c._release()
        print(f"[ep drain] run {i}: drained {runs[-1]['drained']} in "
              f"{runs[-1]['seconds']:.1f} s", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": smi, "torch": torch.__version__, "runs": runs},
                              indent=1, default=str))
    failed = [r for r in runs if not r["drained"]]
    print(f"[ep drain] {len(runs) - len(failed)} of {len(runs)} runs drained ({smi}); "
          f"records in {out}", flush=True)
    for r in failed:
        print(f"[ep drain] run {r['run']} failed: {r['error']}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
