"""The readings that the limits of a cell's check are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --units <n> [--out FILE]

For each seed: the cell's set-up, `--units` units of its traffic (ingest
passes or requests, at the cell's own sizes and load), then the check's two
numbers, max |diff| in LSB and the share of values that differ, for

* the program against the float32 reference (the lower reading), and
* the control, the reference computed in bfloat16, against the float32
  reference on the same sampled outputs (the upper reading).

Prints one JSON line per seed and a last line with the largest program
reading and the smallest control reading of each number. The benchmark's own
runs do not run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def readings(driver, dtype):
    """(max LSB, largest differing share) of the sampled outputs, where
    `dtype` None is the program against the float32 reference and
    otherwise the reference in `dtype` against it."""
    import torch

    from portbench import harness

    if dtype is None:
        pairs = ((got, want) for _, got, want in driver.checks(torch.float32))
    else:
        pairs = ((low.cpu().numpy(), want) for (_, _, want), (_, _, low)
                 in zip(driver.checks(torch.float32), driver.checks(dtype)))
    lsb, frac = 0, 0.0
    for got, want in pairs:
        a, b = harness.compare(got, want)
        lsb, frac = max(lsb, a), max(frac, b)
    return lsb, frac


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--units", type=int, required=True)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.drivers import load_kind, numerics

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    _, config, traffic, _ = harness.cell_files(bench, args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        scratch = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
        try:
            driver = load_kind(traffic["kind"])(config, traffic, seed, args.device, scratch,
                                                False)
            with numerics(traffic):
                driver.setup()
                records = [driver.step(i) for i in range(args.units)]
                driver.release()
            if torch.device(args.device).type == "cuda":
                torch.cuda.empty_cache()
            program = readings(driver, None)
            control = readings(driver, torch.bfloat16)
            row = {"seed": seed, "failed": driver.failed(records), "program": program,
                   "control": control}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del driver
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "program_max": [max(r["program"][i] for r in rows) for i in range(2)],
               "control_min": [min(r["control"][i] for r in rows) for i in range(2)]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
