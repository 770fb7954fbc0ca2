"""Readings for the limits of a cell's correctness check, on the card.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--control] \
        [--out readings.jsonl]

For each seed it sets the cell up as a run does, makes the calls that the
check compares (no timed window), and prints the check's numbers for the
program (the lower readings); with ``--control`` also for the control, the
plain reference computed one precision step below the configuration's
(TF32 for its f32) in the program's place (the upper readings). One JSON
line per seed, on standard output and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from portbench.run import PACKAGE, Run, load_file_module


def readings(workload, seed, control, device="cuda", root="."):
    import torch

    args = SimpleNamespace(workload=workload, seed=seed, seconds=0.0, trace=0, device=device)
    run = Run(args, Path(root))
    run.device = torch.device(device)
    run.device_name = torch.cuda.get_device_name(run.device) if device == "cuda" else "cpu"
    kind = load_file_module(PACKAGE / "kinds" / f"{run.mix['kind']}.py")
    t0 = time.perf_counter()
    work = kind.Workload(run)
    for k in sorted(getattr(work, "keep", ())):
        work.call(k)
    clipped = [float(((o == 0) | (o == 1)).float().mean()) for o in getattr(work, "kept", {}).values()]
    out = {"workload": workload, "seed": seed, "device": run.device_name,
           "clipped_share": clipped,
           "program": {n: c["value"] for n, c in work.check().items()}}
    if control:
        work.control()
        out["control"] = {n: c["value"] for n, c in work.check().items()}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(args.workload, seed, args.control, args.device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
