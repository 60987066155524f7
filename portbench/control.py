#!/usr/bin/env python3
"""Run a cell with the control or a planted fault in the program's place, on
this machine's GPU at the cell's own size, and print what its check reads.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--fault control]

``--fault control`` (the default) puts the plain reference, with every leaf
left unhashed, in the program's place; ``state_unchanged``, ``half_batch``
and ``answer_altered`` plant that fault in the program's kernel wrappers
(``harness/control.py``).  Each seed runs a short window (``--seconds``);
every line printed is one seed's ``checks`` and ``correct``, which has to be
false.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="control")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench.harness import control, runner

    program = control.ReferenceProgram if args.fault == "control" else None
    for seed in (int(s) for s in args.seeds.split(",")):
        plant = contextlib.nullcontext() if program else control.planted(args.fault)
        with plant:
            result, _ = runner.run(args.workload, seed, args.seconds, False, program=program)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
