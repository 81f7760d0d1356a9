"""Defensive-mixture IS vs pure-flow IS on many-well: the alpha lever.

The round-5 mechanism result (RESULTS.md "the many-well -1.2-nat logZ
loop, closed") isolated the one-shot estimator's logZ deficit as a
finite-N tilt under heavy-tailed pullback weights. The N lever shrinks
it as O(var/N) (benchmarks/many_well_is_n_scaling.py); this script
measures the *alpha* lever — mixing a wide defensive component into the
proposal (drivers/mfm.sample_flow_defensive_parts) bounds every weight
at pi/((1-a) q_def), attacking the tail itself at fixed N.

Protocol: train one many-well MFM cell (showdown config at --dim), then
sweep alpha in {1.0 = pure flow, 0.95, 0.9, 0.75, 0.5} at fixed N with
replicated keys; report per-alpha mean logZ tilt vs the quadrature truth
and the realized IS-ESS fraction.

Emits one JSON (default RESULTS_raw_many_well_defensive_is.json):
  {"dim": d, "logz_true": ..., "n": N, "reps": R,
   "sweep": [{"alpha": a, "logz_mean": ..., "logz_ci95": ...,
              "tilt": ..., "ess_frac_mean": ...}]}

``--cpu`` forces the CPU backend via jax.config before the backend
initializes.
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from mfm_tpu.config import preset
from mfm_tpu.drivers.mfm import (
    run_mfm,
    sample_flow_defensive_parts,
    sample_flow_parts,
)
from mfm_tpu.targets import IndepGaussian, ManyWell


def quadrature_truth(dim):
    """Exact many-well normalizer: dim/2 * (logZ_x1 + logZ_gauss)."""
    import numpy as np

    grid = np.linspace(-3.5, 3.5, 20001)
    logp = -(grid**4) + 6.0 * grid**2 + 0.5 * grid
    z1 = np.trapezoid(np.exp(logp), grid)
    return (dim // 2) * (math.log(z1) + 0.5 * math.log(2 * math.pi))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="RESULTS_raw_many_well_defensive_is.json")
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--learning-iter", type=int, default=None,
                    help="override the preset training budget (a short "
                         "budget leaves a mode-miscalibrated flow — the "
                         "regime the defensive mixture is for)")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--alphas", default="1.0,0.95,0.9,0.75,0.5")
    ap.add_argument("--defensive-var", type=float, default=4.0,
                    help="variance of the N(0, v I) defensive component "
                         "(wells at +-sqrt(3), support |x1| <= 3.5)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (handled at import)")
    args = ap.parse_args()

    logz_true = quadrature_truth(args.dim)
    cfg = preset("many-well", seed=args.seed)
    cfg.dim = args.dim
    if args.learning_iter is not None:
        cfg.learning_iter = args.learning_iter
    target = ManyWell(args.dim)

    t0 = time.time()
    run = run_mfm(target, cfg)
    jax.block_until_ready(run.train.params)
    train_wall = time.time() - t0

    transport, params, ref = run.transport, run.train.params, run.ref_dist
    wide = IndepGaussian(args.dim, mean=0.0, var=args.defensive_var)

    def one(alpha, key):
        if alpha >= 1.0:
            _, _, log_w = sample_flow_parts(
                transport, params, ref, key, args.n, target
            )
        else:
            _, _, log_w = sample_flow_defensive_parts(
                transport, params, ref, key, args.n, target, wide, alpha
            )
        lse = jax.nn.logsumexp(log_w)
        logz = lse - jnp.log(log_w.shape[0])
        ess = jnp.exp(2.0 * lse - jax.nn.logsumexp(2.0 * log_w))
        return float(logz), float(ess) / log_w.shape[0]

    sweep = []
    for alpha in [float(a) for a in args.alphas.split(",")]:
        vals, esss = [], []
        for r in range(args.reps):
            key = jax.random.fold_in(jax.random.PRNGKey(1000 + args.seed), r)
            logz, ess = one(alpha, key)
            vals.append(logz)
            esss.append(ess)
        mean = sum(vals) / len(vals)
        sd = (sum((v - mean) ** 2 for v in vals) / max(len(vals) - 1, 1)) ** 0.5
        row = {
            "alpha": alpha,
            "logz_mean": round(mean, 4),
            "logz_ci95": round(1.96 * sd / len(vals) ** 0.5, 4),
            "tilt": round(mean - logz_true, 4),
            "ess_frac_mean": round(sum(esss) / len(esss), 6),
        }
        sweep.append(row)
        print(json.dumps(row), flush=True)

    out = {
        "dim": args.dim,
        "logz_true": round(logz_true, 5),
        "n": args.n,
        "reps": args.reps,
        "defensive_var": args.defensive_var,
        "train_time_s": round(train_wall, 2),
        "device": str(jax.devices()[0]),
        "sweep": sweep,
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
