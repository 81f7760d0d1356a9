"""Inner-moves dose-response for the many-well flow-SMC log-normalizer.

RESULTS.md ("The finishers repair it") measured a consistent -1.2 +/- 0.3
nat logZ bias on the d=32 many-well (truth 164.696, exactly computable by
quadrature) and attributed it to under-equilibration: the preset gives
iter_per_temp = 1 inner MCMC move per tempering increment, and 1-move
mixing on a 2^16-mode pullback is the classic SMC low-bias regime (exact
divergence at d=32 rules out the probe-bias mechanism that explained the
pines +1.8-nat tilt). This script tests that attribution directly: train
ONE flow (seed 0, full preset), then run flow-SMC at num_mcmc_steps in
{1, 4, 16} x 3 SMC seeds each, holding everything else fixed. If mixing
is the driver, the bias should shrink monotonically toward truth as the
dose rises.

Usage: python benchmarks/many_well_inner_moves.py [out.json]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from mfm_tpu.cli import make_target
from mfm_tpu.config import preset
from mfm_tpu.drivers import run_mfm
from mfm_tpu.drivers.flow_smc import run_flow_smc

def quadrature_truth():
    g = np.linspace(-4.0, 4.0, 400001)
    lp = -(g**4) + 6.0 * g**2 + 0.5 * g
    log_i = lp.max() + np.log(np.trapezoid(np.exp(lp - lp.max()), g))
    return 16.0 * (log_i + 0.5 * np.log(2.0 * np.pi))


def main(out_path="RESULTS_raw_many_well_inner_moves.json"):
    logz_true = quadrature_truth()
    cfg = preset("many-well", seed=0)
    target = make_target("many-well")

    # resume: reuse finished cells from an existing artifact, so the grid
    # can be driven to completion across multiple processes. The flow
    # retrain is deterministic (seed 0), so resumed cells compose.
    done = {}
    if os.path.exists(out_path):
        with open(out_path) as fh:
            prev = json.load(fh)
        done = {(r["n_mcmc"], r["smc_seed"]): r for r in prev.get("rows", [])}

    t0 = time.time()
    run = run_mfm(target, cfg)
    jax.block_until_ready(run.train.params)
    t_train = time.time() - t0

    rows = []
    out = {
        "log_z_true": float(logz_true),
        "train_time_s": round(t_train, 2),
        "rows": rows,
    }
    for n_mcmc in (1, 4, 16):
        for smc_seed in (100, 101, 102):
            if (n_mcmc, smc_seed) in done:
                rows.append(done[(n_mcmc, smc_seed)])
                print("reusing", rows[-1], flush=True)
                continue
            t0 = time.time()
            r = run_flow_smc(
                target, cfg, run.transport, run.train.params, run.ref_dist,
                key=jax.random.PRNGKey(smc_seed), n_particles=4096,
                n_steps=32, num_mcmc_steps=n_mcmc,
            )
            jax.block_until_ready(r.samples)
            rows.append({
                "n_mcmc": n_mcmc,
                "smc_seed": smc_seed,
                "log_z": float(r.log_z),
                "bias": float(r.log_z) - float(logz_true),
                "lmbda": float(r.lmbda),
                "ess_fraction": float(r.ess_fraction),
                "time_s": round(time.time() - t0, 2),
            })
            print(rows[-1], flush=True)
            # write after every cell: a fault mid-grid must not lose the
            # completed cells
            with open(out_path, "w") as fh:
                json.dump(out, fh, indent=2)
    for n_mcmc in (1, 4, 16):
        b = [row["bias"] for row in rows if row["n_mcmc"] == n_mcmc]
        print(
            f"n_mcmc={n_mcmc}: bias {np.mean(b):+.3f} +/- {np.std(b):.3f}"
            f" nats ({len(b)} seeds)",
            flush=True,
        )


if __name__ == "__main__":
    main(*sys.argv[1:])
