"""One-shot IS logZ vs sample count N on many-well (d=32): the N lever.

The round-5 mechanism result (RESULTS.md "the many-well -1.2-nat logZ
loop, closed") says the logZ deficit is a finite-N estimator tilt of
log Z_hat = logsumexp(log w) - log N under heavy-tailed pullback weights
(E[log Z_hat] <= log Z, gap ~ per-sample weight variance / N), NOT a
transport error. Its falsifiable prediction for the SHOWDOWN estimator
(one-shot flow IS, reference exe_flow_matching.py:453-459): at a fixed
trained flow the tilt must shrink monotonically as N grows, with no
retraining and no ODE-grid change. This script measures that
dose-response: train the showdown many-well MFM cell once, then sweep
N over two orders of magnitude with replicated keys.

Emits one JSON (default RESULTS_raw_many_well_is_n.json):
  {"logz_true": ..., "train": {...},
   "sweep": [{"n": N, "logz_mean": ..., "logz_ci95": ..., "tilt": ...}]}

Transport pushes are chunked (<= --chunk samples per XLA execution) to
bound device memory.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# --cpu must take effect before the backend initializes
if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from mfm_tpu.cli import make_target
from mfm_tpu.config import preset
from mfm_tpu.drivers.mfm import run_mfm


def quadrature_logz_many_well():
    """Exact d=32 normalizer (same quadrature as baseline_showdown.py)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline_showdown.py")
    spec = importlib.util.spec_from_file_location("baseline_showdown", path)
    sd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sd)
    return sd.quadrature_logz_many_well()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="RESULTS_raw_many_well_is_n.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--learning-iter", type=int, default=2000)
    ap.add_argument("--ns", default="4096,16384,65536,262144")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (smoke testing)")
    args = ap.parse_args()

    logz_true = quadrature_logz_many_well()
    cfg = preset("many-well", learning_iter=args.learning_iter,
                 mcmc_per_flow_steps=10.0)
    cfg.seed = args.seed
    target = make_target("many-well")

    t0 = time.time()
    run = run_mfm(target, cfg)
    jax.block_until_ready(run.train.params)
    train_wall = time.time() - t0

    transport, params, ref = run.transport, run.train.params, run.ref_dist

    from functools import partial

    @partial(jax.jit, static_argnums=1)
    def logw_chunk(key, n_static):
        k_ref, k_hutch = jax.random.split(key)
        u = ref.sample(k_ref, (n_static,))
        x, logdet = transport.forward(params, u, k_hutch)
        return target.log_prob(x) - (ref.log_prob(u) - logdet)

    def logz_at_n(key, n):
        """log Z_hat over n samples, streamed in bounded chunks via a
        running logsumexp (no O(n) device residency)."""
        m = -jnp.inf
        acc = 0.0
        done = 0
        while done < n:
            key, sub = jax.random.split(key)
            c = min(args.chunk, n - done)
            lw = logw_chunk(sub, c)
            lw = jnp.where(jnp.isfinite(lw), lw, -jnp.inf)
            cm = jnp.maximum(m, jnp.max(lw))
            acc = acc * jnp.exp(m - cm) + jnp.sum(jnp.exp(lw - cm))
            m = cm
            done += c
        return float(m + jnp.log(acc) - jnp.log(n))

    ns = [int(s) for s in args.ns.split(",")]
    sweep = []
    for n in ns:
        vals = []
        for r in range(args.reps):
            key = jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(args.seed), n), r)
            t1 = time.time()
            vals.append(logz_at_n(key, n))
            print(f"[is_n] n={n} rep={r}: logz={vals[-1]:.3f} "
                  f"({time.time() - t1:.1f}s)", flush=True)
        mean = sum(vals) / len(vals)
        ci = 1.96 * (sum((v - mean) ** 2 for v in vals) / len(vals)) ** 0.5
        sweep.append({"n": n, "logz_mean": mean, "logz_ci95": ci,
                      "tilt": mean - logz_true, "reps": vals})
    out = {
        "logz_true": logz_true,
        "train": {"seed": args.seed, "learning_iter": args.learning_iter,
                  "train_wall_s": round(train_wall, 1),
                  "device": str(jax.devices()[0])},
        "sweep": sweep,
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps({"is_n_done": True, "out": args.out,
                      "tilts": {s["n"]: round(s["tilt"], 3)
                                for s in sweep}}))


if __name__ == "__main__":
    main()
