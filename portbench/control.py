"""Readings that the cells' limits are set from.

    python3 -m portbench.control --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s> [--out <file.jsonl>]

For each of `--seeds` it makes a run of the cell as the benchmark does
(set-up, a window of `--seconds`, the check) and records the numbers the
check compared: the lower readings. For each of `--control-seeds` it puts
the reference computed in bfloat16, the precision below the configuration's
float32, in the program's place on the inputs the seed chose for the check
and records the same numbers: the upper readings. Prints one JSON line a
reading and a summary; the program's readings and the control's run in one
process, on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench.harness import run_cell
from portbench.registry import Registry


def _ints(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(reg, name, seeds, control_seeds, seconds, device, emit) -> dict:
    cell = reg.cell(name)
    cfg = reg.config(cell["config"])
    lower, upper = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        r = run_cell(reg, name, seed, seconds, False, device, t0, cell=cell, cfg=cfg)
        nums = {k: v["value"] for k, v in r["checks"].items()}
        emit({"workload": name, "side": "program", "seed": seed, "correct": r["correct"],
              "numbers": nums, "metrics": r["metrics"], "seconds": time.perf_counter() - t0})
        for k, v in nums.items():
            lower[k] = max(lower.get(k, 0.0), v if v is not None else float("inf"))
    for seed in control_seeds:
        t0 = time.perf_counter()
        drv = reg.driver(cell["driver"]).Driver(cfg, cell, seed, device)
        drv.finish()
        samples = drv.control(torch.bfloat16)
        nums = {k: max(s[k] for s in samples) for k in samples[0]}
        emit({"workload": name, "side": "control", "seed": seed, "numbers": nums,
              "readings": getattr(drv, "diagnostics", []), "seconds": time.perf_counter() - t0})
        for k, v in nums.items():
            upper[k] = min(upper.get(k, float("inf")), v)
        del drv
    return {"workload": name, "lower": lower, "upper": upper, "limits": cell["limits"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        emit(readings(Registry(), args.workload, args.seeds, args.control_seeds, args.seconds,
                      "cuda", emit))
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
