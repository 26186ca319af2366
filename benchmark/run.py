"""Run one cell of the benchmark of ``nmrf_tpu_torch`` on this machine.

    python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  In order: the cell's files by name
(``harness.Cell``), set-up (weights made from the seed on the card with
the plain reference and loaded into the measured model, the traffic's
inputs from the seed, every shape the traffic uses warmed up), then
``--seconds`` of measurement, then with ``--trace 1`` a short profiled
stretch for the per-layer metrics, then the output check against the
plain float32 reference (``benchmark/reference``).  The last line of
stdout is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``
(each compared number beside its limit, also the last lines of stderr).

Without a CUDA device, or with fewer than the cell asks for, it exits
with 2 and prints no result.  ``--device cpu`` rehearses a cell at a
tiny size on the CPU (the tests); it reads only program counters, so no
device metric carries a CPU number.  ``--root DIR`` reads
``BENCHMARK.json`` and the cell's files from DIR."""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

from . import harness


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--root", default=str(harness.ROOT))
    return p


def main(argv=None, start=None):
    """Run a cell; returns the result's dict (also printed)."""
    start = harness.process_start() if start is None else start
    args = _parser().parse_args(argv)
    harness.cache_env()
    import torch

    cell = harness.Cell(args.root, args.workload)
    device = harness.device_for(args.device, cell.chips)
    on_card = device.type == "cuda"
    generator = cell.module("traffic", cell.traffic["generator"]).Generator(
        cell, args.seed, device, trace=bool(args.trace))
    generator.setup()
    rec = {"setup_s": time.time() - start}
    rec.update(generator.measure(args.seconds))
    # a generator that runs ranks of its own gives the fullest card's peak
    peak = rec.get("memory_peak_bytes")
    if peak is None:
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    card = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        with tempfile.TemporaryDirectory() as tmp:
            rec.update(generator.trace(Path(tmp) / "trace.json"))
        if on_card:
            trace = rec["trace"]
            card["busy_s"] = trace.busy_ms() / 1e3
            card["window_s"] = trace.window_ms() / 1e3
            breakdown = {"device_ops": trace.top_ops(),
                         "idle_gaps": trace.idle_gaps()}
    metrics = harness.read_metrics(
        cell, "per_layer" if args.trace else "end_to_end", rec, on_card)
    t0 = time.time()
    numbers = generator.check()
    harness.log(f"set-up {rec['setup_s']:.2f} s, window {rec['window_s']:.2f}"
                f" s, check {time.time() - t0:.2f} s; readings "
                + json.dumps(numbers))
    correct, checks = harness.judge(numbers, cell.limits)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"forbidden modules loaded: {found}")
        raise SystemExit(3)
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": card}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
