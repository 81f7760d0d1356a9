"""Isolate the mechanism of the many-well flow-SMC logZ bias.

Round-5 measurements refuted both standing attributions on the d=32
many-well (truth 164.696): the -1.2-nat bias is FLAT in inner MCMC moves
(1/4/16 — not equilibration, RESULTS_raw_many_well_inner_moves.json) and
the discrete-map logdet error is +2e-4 nats (not the transport Jacobian,
RESULTS_raw_many_well_logz_bias.json). The surviving candidate is the SMC
estimator itself: log Ẑ = Σ log-mean-w is unbiased in Z, so
E[log Ẑ] - log Z ≈ -Var/2-type tilt that grows with per-step weight
variance and shrinks with particles N and anneal resolution n_steps. On a
pullback whose mode weights the flow gets wrong (KSD-blind, RESULTS.md
round 3), the per-step weights are heavy-tailed and the tilt is O(1) while
seed-to-seed spread stays small — exactly the observed signature.

This script measures the dose-responses that discriminate it, on a
d-configurable many-well (d=8 runs on the CPU mesh in minutes; same
quadrature truth formula):

1. bias vs alpha in {0.95, 0.99, 0.999} (fixed N) — the ESS target that
   actually controls anneal resolution: the adaptive schedule saturates
   lambda=1 well inside the n_steps cap, so raising the CAP is a no-op
   (measured: bit-identical logZ at n_steps 16 vs 32 on d=8 — the first
   16 of split(key, 32) are the first 16 counters, and post-saturation
   steps add exactly-zero increments). Higher alpha = smaller per-step
   delta = lower per-step weight variance — prediction: bias shrinks.
2. bias vs N in {1024, 4096, 16384} (fixed alpha) — prediction: shrinks.
3. plain-SMC geometric-bridge control (no flow) — prediction: unbiased.

Usage:
  python benchmarks/many_well_bias_mechanism.py [out.json] [--dim 8]
         [--seeds 100,101,102] [--cpu]

``--cpu`` forces the CPU backend via jax.config before the backend
initializes — the d=8 grid runs on the host in minutes.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import numpy as np

from mfm_tpu.config import preset
from mfm_tpu.drivers import run_mfm
from mfm_tpu.drivers.flow_smc import run_flow_smc
from mfm_tpu.drivers.smc_run import run_smc
from mfm_tpu.targets import ManyWell


def quadrature_truth(dim):
    g = np.linspace(-4.0, 4.0, 400001)
    lp = -(g**4) + 6.0 * g**2 + 0.5 * g
    log_i = lp.max() + np.log(np.trapezoid(np.exp(lp - lp.max()), g))
    return (dim // 2) * (log_i + 0.5 * np.log(2.0 * np.pi))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?",
                    default="RESULTS_raw_many_well_bias_mechanism.json")
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--seeds", default="100,101,102")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (handled at import)")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]

    logz_true = quadrature_truth(args.dim)
    cfg = preset("many-well", seed=0)
    cfg.dim = args.dim
    target = ManyWell(args.dim)

    prev = {}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            prev = json.load(fh)

    t0 = time.time()
    run = run_mfm(target, cfg)
    jax.block_until_ready(run.train.params)

    rows = list(prev.get("rows", []))
    have = {(r["kind"], r["alpha"], r["n_particles"], r["seed"])
            for r in rows}
    out = {
        "dim": args.dim,
        "log_z_true": float(logz_true),
        "train_time_s": round(time.time() - t0, 2),
        "rows": rows,
    }

    grid = (
        # (1) anneal-resolution dose-response at fixed N: alpha is the
        # knob (per-step ESS target of the bisection, smc/ess.py);
        # n_steps scales as the cap so the finer schedules can finish
        [("flow_smc", a, 4096) for a in (0.9, 0.95, 0.99)]
        # (2) particle dose-response at the preset alpha
        + [("flow_smc", 0.95, n) for n in (1024, 16384)]
        # (3) no-flow control: plain SMC on the geometric bridge
        + [("plain_smc_geometric", 0.95, 4096)]
    )
    # per-process cell quota; rerun to resume from the artifact
    max_cells = int(os.environ.get("MFM_MAX_CELLS", "4"))
    new_cells = 0
    for kind, alpha, n_particles in grid:
        n_cap = {0.9: 32, 0.95: 32, 0.99: 160}[alpha]
        for seed in seeds:
            if (kind, alpha, n_particles, seed) in have:
                continue
            if new_cells >= max_cells:
                print(f"cell quota ({max_cells}) hit; rerun to continue",
                      flush=True)
                sys.exit(3)
            new_cells += 1
            t0 = time.time()
            if kind == "flow_smc":
                fcfg = preset("many-well", seed=0, alpha=alpha)
                fcfg.dim = args.dim
                r = run_flow_smc(
                    target, fcfg, run.transport, run.train.params,
                    run.ref_dist, key=jax.random.PRNGKey(seed),
                    n_particles=n_particles, n_steps=n_cap,
                    num_mcmc_steps=1, chunk_steps=32,
                )
                log_z, lmbda = float(r.log_z), float(r.lmbda)
            else:
                scfg = preset("many-well", seed=seed, learning_iter=64,
                              num_chain=n_particles, alpha=alpha)
                scfg.dim = args.dim
                scfg.smc_path = "geometric"
                r = run_smc(target, scfg, key=jax.random.PRNGKey(seed))
                log_z, lmbda = float(r.log_z), float(r.lmbda)
            row = {
                "kind": kind, "alpha": alpha,
                "n_particles": n_particles, "seed": seed,
                "log_z": log_z, "bias": log_z - float(logz_true),
                "lmbda": lmbda, "time_s": round(time.time() - t0, 2),
            }
            rows.append(row)
            print(row, flush=True)
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=2)

    for kind, alpha, n_particles in grid:
        b = [r["bias"] for r in rows
             if (r["kind"], r["alpha"], r["n_particles"])
             == (kind, alpha, n_particles)]
        print(f"{kind} alpha={alpha} N={n_particles}: "
              f"bias {np.mean(b):+.3f} +/- {np.std(b):.3f}", flush=True)


if __name__ == "__main__":
    main()
