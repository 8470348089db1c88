#!/usr/bin/env python3
"""The instruction mix of a compiled kernel of the port, region by region.

    python3 tools/sass_mix.py [--kernel scan_bwd_walk_kernelILi4ELi4E] [--steps 64]

Builds the kernel library (``kernels/_build.py``) if it is not built, dumps
its SASS with ``cuobjdump`` (CUDA toolkit, on the machine with the card)
and, for each function whose mangled name holds ``--kernel``, prints the
instruction count and opcode mix of the whole function and of each stretch
between two ``BAR.SYNC``. A loop whose body is unrolled runs each stretch
once an iteration, so a stretch's count over ``--steps`` (the state steps
a thread covers an iteration: the walk kernel's at (4, 4) covers 16 steps x
4 states = 64) is its issue slots a state step. Each stretch is given in
all its instructions (static: paths a run does not take, such as the
scalar staging beside the 16-byte one, count too, so this is an upper
bound) and in its arithmetic, special-function, shared-memory and shuffle
instructions (FP32, MUFU, LDS / STS, SHFL), the work the step must do.
Stretches before the first barrier and after the last hold the set-up, the
staging of the next chunk and the loop's tail.
"""
from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402

OPCODE = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    return found


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="scan_bwd_walk_kernelILi4ELi4E",
                    help="a substring of the mangled function name")
    ap.add_argument("--steps", type=int, default=64,
                    help="state steps a thread covers in one iteration of the loop")
    args = ap.parse_args()
    lib = _build.build()
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    found = 0
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.splitlines()[0].strip()
        if args.kernel not in name:
            continue
        found += 1
        regions, ops = [collections.Counter()], collections.Counter()
        for line in func.splitlines():
            m = OPCODE.match(line)
            if not m:
                continue
            op = m.group(2).split(".")[0]
            ops[op] += 1
            regions[-1][op] += 1
            if m.group(2).startswith("BAR.SYNC"):
                regions.append(collections.Counter())
        print(f"{name}: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(24)))
        loop_all = loop_work = 0
        for i, r in enumerate(regions):
            fp32 = r["FMUL"] + r["FADD"] + r["FFMA"]
            work = fp32 + r["MUFU"] + r["LDS"] + r["STS"] + r["SHFL"]
            total = sum(r.values())
            if i:
                loop_all, loop_work = loop_all + total, loop_work + work
            print(f"  stretch {i} (after {i} barriers): {total} instructions "
                  f"({total / args.steps:.2f} a state step), MUFU {r['MUFU']}, FP32 {fp32}, "
                  f"LDS {r['LDS']}, STS {r['STS']}, SHFL {r['SHFL']} (work "
                  f"{work / args.steps:.2f} a state step)")
        print(f"  after the first barrier: {loop_all / args.steps:.2f} instructions a state "
              f"step, of them work {loop_work / args.steps:.2f}")
    if not found:
        sys.exit(f"no function in {lib} holds {args.kernel!r}")


if __name__ == "__main__":
    main()
