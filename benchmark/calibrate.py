"""Readings for the limits of a cell's output check, in one process.

    python3 -m benchmark.calibrate --workload CELL --mode MODE
        --seeds N [N ...] [--seconds S] [--device cuda|cpu]

MODE ``program``: for each seed a whole run of the cell's generator (set-up,
``--seconds`` of the window, the check) and its compared numbers, the
lower readings.  ``control``: the float8 reference in the program's place
(the generator's ``control``), the upper readings.  ``half_batch`` (training
cells): the reference on the first half of each batch in the program's
place (the generator's ``fault``).  One JSON line a seed."""

import argparse
import json
import time

from . import harness


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("program", "control", "half_batch"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--root", default=str(harness.ROOT))
    args = p.parse_args(argv)
    harness.cache_env()
    cell = harness.Cell(args.root, args.workload)
    device = harness.device_for(args.device, cell.chips)
    Generator = cell.module("traffic", cell.traffic["generator"]).Generator
    rows = []
    for seed in args.seeds:
        t0 = time.time()
        d = Generator(cell, seed, device)
        if args.mode == "program":
            d.setup()
            d.measure(args.seconds)
            numbers = d.check()
        else:
            d.inputs()
            numbers = d.control() if args.mode == "control" \
                else d.fault(args.mode)
        del d
        harness.free(device)
        rows.append({"workload": cell.name, "mode": args.mode, "seed": seed,
                     "numbers": numbers, "s": round(time.time() - t0, 1)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
