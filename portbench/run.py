"""Run one cell of the benchmark of `imagepipe_tpu_torch` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (the kernels' library from the port's
build directory in the checkout, the inputs from the seed, a warm pass of
the cell's traffic), then the measured window of `--seconds`, then the check
of a seeded sample of the window's outputs against the plain reference in
portbench/reference/. The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 breakdown, and the
numbers compared beside their limits (checks); the same numbers are the
last lines of standard error. Exits 2 without a CUDA device, 3 if JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    chips = harness.find_workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     T_START, bench=bench)
    for line in lines:
        print(line, flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {found}: the port's benchmark may load neither JAX nor the "
              f"JAX package", file=sys.stderr)
        return 3
    for key, number in result["checks"].items():
        side = "at least" if key == "outputs_compared" else "at most"
        print(f"check {key}: {number['value']!r} (limit: {side} {number['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
