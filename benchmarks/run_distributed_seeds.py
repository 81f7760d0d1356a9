"""Multi-process seed-replication demo & runbook (CPU devices, gloo).

Each process trains its strided share of the seed list locally (the
reference's 10-seed protocol, /root/reference/multi_modal.py:118-131), then
one tiny all-gather moves the per-seed metric rows across processes so
every process prints the identical mean ± 1.96σ aggregate.

Run (two local processes, virtual CPU devices):

    python benchmarks/run_distributed_seeds.py            # spawns 2 workers
    # or explicitly, one command per process / host:
    python benchmarks/run_distributed_seeds.py --process-id 0 --num-processes 2
    python benchmarks/run_distributed_seeds.py --process-id 1 --num-processes 2

This stays a CPU demo: on a GPU host one process drives every card.
"""

import argparse
import json
import os
import subprocess
import sys

# the script lives in benchmarks/; make the repo root importable when run
# directly (python adds the script dir, not the cwd, to sys.path)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def worker(args):
    from mfm_tpu.parallel.distributed import (
        aggregate_row,
        allgather_rows,
        initialize_distributed,
        local_seeds,
    )

    initialize_distributed(
        args.coordinator,
        args.num_processes,
        args.process_id,
        cpu_devices_per_process=args.cpu_devices or None,
    )

    import jax

    from mfm_tpu.config import MFMConfig
    from mfm_tpu.drivers import evaluate_samples, run_mfm, sample_flow
    from mfm_tpu.targets import four_mode_mixture

    seeds = local_seeds(
        [i**10 for i in range(args.num_seeds)],
        args.process_id,
        args.num_processes,
    )
    target = four_mode_mixture()
    rows = []
    for seed in seeds:
        cfg = MFMConfig(
            example="4-mode", dim=2, seed=seed, num_chain=32,
            learning_iter=args.learning_iter, chunk_size=args.learning_iter,
            hidden_x=(16,), hidden_t=(16,), hidden_xt=(16,), fourier_dim=8,
            ode_steps=6, anneal_iter=20, num_anneal_temp=20,
        )
        run = run_mfm(target, cfg)
        fs, es, _ = sample_flow(run, jax.random.PRNGKey(seed + 999), 256, target)
        m = evaluate_samples(target, fs, es, target.sample(jax.random.PRNGKey(1), (256,)))
        rows.append([m["logpdf_star"], m["stein_u_star"], m["mmd_star"], run.train_time])

    gathered = allgather_rows(rows)
    mean, ci = aggregate_row(gathered)
    print(
        json.dumps(
            {
                "process_id": args.process_id,
                "local_seeds": seeds,
                "total_rows": int(gathered.shape[0]),
                "global_devices": len(jax.devices()),
                "local_devices": len(jax.local_devices()),
                "aggregate_mean": [round(float(v), 6) for v in mean],
                "aggregate_ci95": [round(float(v), 6) for v in ci],
            }
        ),
        flush=True,
    )


def launch(args):
    """Spawn num_processes copies of this script locally. Each child's
    stdout is captured separately so the JSON result lines cannot
    interleave on the shared pipe."""
    procs = []
    for pid in range(args.num_processes):
        cmd = [
            sys.executable, __file__,
            "--process-id", str(pid),
            "--num-processes", str(args.num_processes),
            "--coordinator", args.coordinator,
            "--cpu-devices", str(args.cpu_devices),
            "--num-seeds", str(args.num_seeds),
            "--learning-iter", str(args.learning_iter),
        ]
        procs.append(
            subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
        )
    rc = 0
    for p in procs:
        out, _ = p.communicate()
        sys.stdout.write(out)
        rc = max(rc, p.returncode)
    sys.exit(rc)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--coordinator", default="localhost:12987")
    p.add_argument("--cpu-devices", type=int, default=2,
                   help="virtual CPU devices per process")
    p.add_argument("--num-seeds", type=int, default=4)
    p.add_argument("--learning-iter", type=int, default=30)
    args = p.parse_args()
    if args.process_id is None:
        launch(args)
    else:
        worker(args)


if __name__ == "__main__":
    main()
