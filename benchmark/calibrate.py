"""The readings that the comparison's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload CELL --seeds 11 12 ... \
        [--control_seeds 11 12 13] [--out FILE]

For each seed, in one process: the cell's set-up, one whole sweep of the
program (the timed path at the timed sizes, as a run's window drives it),
the plain reference over the categories a run with that seed compares,
and the numbers a run compares (``alpha_gap``, ``x_gap``).  For each
control seed the same categories also go through the precision control
(the reference with every product's operands in fp8 e4m3), compared with
the reference the same way.  One JSON line a reading on standard output
(and in ``--out``).  The lower reading of a number is the largest over the
program's seeds, the upper the smallest over the control's.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.harness import check, manifest, traffic  # noqa: E402
from benchmark.reference import fp8  # noqa: E402


def readings(cell, seed: int, device: str, control: bool) -> list[dict]:
    tree = tempfile.mkdtemp(prefix="bench-calib-")
    try:
        mix, weights, program, work = run.prepare(cell, seed, device, tree,
                                                 warm=False)
        sample = traffic.check_sample(mix, seed)
        win = run.run_window(program, tree, 0.0, sample, work.p, work.d)
        run.free_program(program, device == "cuda")
        ref = run.reference_answers(cell, mix, tree, weights, sample,
                                    device, fp8.exact)
        kinds = [("program", win.answers)]
        if control:
            ctl = run.reference_answers(cell, mix, tree, weights, sample,
                                        device, fp8.fp8)
            kinds.append(("control", {(0, c): ctl[c] for c in sample}))
        out = []
        for kind, answers in kinds:
            numbers, correct = check.compare(answers, ref, cell.limits,
                                             win.bad, win.failed)
            per_cat = {c: [check.row_gap(a, ref[c][0]),
                           check.row_gap(x, ref[c][1])]
                       for (_, c), (a, x) in answers.items()}
            out.append({"cell": cell.name, "seed": seed, "kind": kind,
                        "alpha_gap": numbers["alpha_gap"]["value"],
                        "x_gap": numbers["x_gap"]["value"],
                        "correct_under_limits": correct,
                        "per_category": per_cat})
        return out
    finally:
        shutil.rmtree(tree, ignore_errors=True)
        if device == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, nargs="*", default=())
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 3
    run.keep_caches_in(run.ROOT)
    cell = manifest.load_cell(args.workload)
    for seed in dict.fromkeys([*args.seeds, *args.control_seeds]):
        t = time.perf_counter()
        for r in readings(cell, seed, "cuda", seed in args.control_seeds):
            r["seconds"] = time.perf_counter() - t
            line = json.dumps(r)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
