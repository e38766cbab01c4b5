"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``attngan_torch/``. It needs CUDA
devices, as many as the cell asks for, and exits 1 without a result line
where they are missing, where the port is missing, or where ``jax``,
``jaxlib``, ``flax`` or the JAX package was loaded. The last line of
standard output is the result as one JSON object; the numbers the check
compared, each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "attngan_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    from perfbench import harness

    started = harness.process_start()
    benchmark = harness.benchmark_spec()
    cell = harness.cell_spec(args.workload, benchmark)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the GPU only",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA devices; "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    try:
        import attngan_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is missing from the checkout: {e}", file=sys.stderr)
        return 1
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              benchmark, started=started)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 1
    compared = result.pop("compared")
    result["compared"] = {c["name"]: {"value": c["value"],
                                      "limit": c["limit"]}
                          for c in compared}
    print(json.dumps(result), flush=True)
    for c in compared:
        print(f"{c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
