"""Drive the full baseline showdown one cell per subprocess.

One (target, method, seed) CELL per child process, run one after another,
so a failed cell costs that cell only and only one process holds the
accelerator (baseline_showdown.py resumes finished cells from the
incremental artifact).

Usage:
  python benchmarks/run_showdown_grid.py [out.json] [--targets a,b]
         [--methods m1,...] [--group-timeout S]
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?",
                    default="RESULTS_raw_baseline_showdown.json")
    ap.add_argument("--targets", default="4-mode,many-well,gaussian-mixture")
    ap.add_argument("--methods", default="mfm,smc,flowmc,dds,fab")
    ap.add_argument("--seeds", default="0,1,1024")
    ap.add_argument("--group-timeout", type=float, default=2400)
    ap.add_argument("--no-final-pass", action="store_true",
                    help="skip the aggregate-only rebuild pass (useful when "
                         "driving single cells in a priority sequence)")
    args = ap.parse_args()

    def done_cells():
        if not os.path.exists(args.out):
            return set()
        with open(args.out) as fh:
            cells = json.load(fh).get("cells", {})
        return {k for k, v in cells.items() if "error" not in v}

    outcomes = {}
    for target in args.targets.split(","):
        for method in args.methods.split(","):
            for seed in args.seeds.split(","):
                label = f"{target}/{method}/seed{seed}"
                if label in done_cells():
                    outcomes[label] = "already done"
                    continue
                t0 = time.time()
                try:
                    r = subprocess.run(
                        [sys.executable,
                         os.path.join(HERE, "baseline_showdown.py"),
                         args.out, "--targets", target,
                         "--methods", method, "--seeds", seed],
                        timeout=args.group_timeout,
                    )
                    outcomes[label] = f"rc={r.returncode}"
                except subprocess.TimeoutExpired:
                    outcomes[label] = f"timeout after {args.group_timeout:.0f}s"
                ok = label in done_cells()
                print(f"[grid] {label}: {outcomes[label]}, "
                      f"cell_ok={ok} ({time.time() - t0:.0f}s)", flush=True)
    # final aggregate-only pass: per-seed children leave 1-seed tables, so
    # rebuild every table from the full seed set (pure cell reuse — no
    # device work beyond import). render_showdown.py::rebuild_tables does
    # the same aggregation host-side for RESULTS.md, so --no-final-pass
    # loses nothing when the artifact is only consumed through the renderer.
    if not args.no_final_pass:
        try:
            subprocess.run(
                [sys.executable, os.path.join(HERE, "baseline_showdown.py"),
                 args.out, "--targets", args.targets, "--methods",
                 args.methods, "--seeds", args.seeds],
                timeout=args.group_timeout,
            )
        except subprocess.TimeoutExpired:
            outcomes["final_pass"] = "timeout"
    print(json.dumps({"grid_outcomes": outcomes}))


if __name__ == "__main__":
    main()
