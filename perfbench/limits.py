"""Readings that the check's limits are set from, on the chip at a cell's
own size: the program's numbers on many seeds (the lower readings), and
the control's and the faults' (the upper readings). Not run by the
benchmark's own runs.

    python3 perfbench/limits.py --workload <cell> --seeds 12 \
        --variants control --variant-seeds 3

Each seed builds the cell's driver as a run does (a variant: the driver
built with that variant in the program's place), serves the mix's pool
once through (every sampled entry, the longest requests with them), and
prints one JSON line of the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, cfg, seed, device, variant):
    from perfbench import harness

    t0 = time.perf_counter()
    drv = harness.driver_class(cell["entry"])(cell, cfg, seed, device,
                                              variant)
    for i in range(drv.calls_to_check):
        drv.call(i)
    harness.synchronize(device)
    drv.release()
    compared = drv.check()
    numbers = {c["name"]: c["value"] for c in compared}
    return {"variant": variant, "seed": seed,
            "seconds": time.perf_counter() - t0, "numbers": numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_001)
    p.add_argument("--variants", nargs="*", default=["control"])
    p.add_argument("--variant-seeds", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness

    bench = harness.benchmark_spec()
    cell = harness.cell_spec(args.workload, bench)
    cfg = harness.config_spec(cell["config"])
    device = torch.device("cuda", 0)
    plan = [("program", args.first_seed + k) for k in range(args.seeds)]
    plan += [(v, args.first_seed + 1000 + k) for v in args.variants
             for k in range(args.variant_seeds)]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out = os.path.join(ROOT, "chiprun_out", f"limits-{args.workload}.jsonl")
    with open(out, "a") as f:
        for variant, seed in plan:
            try:
                line = readings(cell, cfg, seed, device, variant)
            except Exception as e:       # a crashing control has failed
                line = {"variant": variant, "seed": seed, "error": repr(e)}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
