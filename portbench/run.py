#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on this machine's NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of the repository.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared with the plain reference beside its limit;
the same numbers are the last lines of standard error.  Exits with 2, and
prints no result, where there is no card or fewer than the cell needs, and
with 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench.harness import manifest, runner

    t_start = runner.process_start()
    import torch

    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    result, checks = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    banned = runner.banned_modules()
    if banned:
        print(f"portbench: the run loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name} = {value}" + ("" if limit is None else f" (limit {limit})"), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
