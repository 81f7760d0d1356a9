"""MFM vs baselines: the measured side-by-side comparison table.

The reference's entire baselines orchestrator exists to produce this table
(exe_others.py: FAB :42-76, SMC :79-111, flowMC :114-199, DDS :247-299,
dispatched from multi_modal.py:100-116) with the metric schema of
exe_flow_matching.py:462-490. This script runs every method on the same
target with the same seed protocol and records that schema side by side:

  logpdf / logpdf*  mean target log-density of raw / IS-corrected samples
  stein_u / stein_v kernelized Stein discrepancy (IMQ beta=-1/2)
  mmd / mmd*        RBF MMD^2 vs exact target samples
  log_z_is          flow-IS normalizer estimate (lse(log w) - log n)
  is_ess_frac       IS effective-sample-size fraction
  train_time_s      wall clock, post-JIT where the method separates compile

Methods: MFM (drivers/mfm), adaptive tempered SMC (drivers/smc_run), and
the in-repo FAB / flowMC / DDS (drivers/{fab,flowmc,dds} via the
drivers/baselines dispatch, so an installed external package would be used
instead, exactly like the reference environment).

Targets: 4-mode (reference README.md:6-20 config), many-well (exact
quadrature normalizer logZ = 164.696 — every method's log_z_is is checked
against truth), and 16-mode gaussian-mixture (exact normalizer 0).

Seeds: the first 3 of the reference's i**10 protocol (multi_modal.py:118).
Output is written incrementally after every (target, method, seed) cell so
a timeout still leaves a complete partial artifact.

Usage:
  python benchmarks/baseline_showdown.py [out.json] [--targets a,b]
         [--methods m1,m2] [--seeds 0,1,1024] [--iters-scale F]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from mfm_tpu.cli import make_target
from mfm_tpu.config import preset
from mfm_tpu.drivers import evaluate_samples, run_mfm, sample_flow
from mfm_tpu.drivers.baselines import run_baseline
from mfm_tpu.drivers.smc_run import run_smc

LSE = jax.scipy.special.logsumexp


def quadrature_logz_many_well():
    """Exact d=32 many-well normalizer: 16 independent 2-D double wells."""
    g = np.linspace(-4.0, 4.0, 400001)
    lp = -(g**4) + 6.0 * g**2 + 0.5 * g
    log_i = lp.max() + np.log(np.trapezoid(np.exp(lp - lp.max()), g))
    return 16.0 * (log_i + 0.5 * np.log(2.0 * np.pi))


# exact normalizers where they exist (normalized densities have logZ = 0)
LOGZ_TRUE = {
    "4-mode": 0.0,
    "gaussian-mixture": 0.0,
    "many-well": None,  # filled from quadrature below
}

# reference benchmark configs (README.md:6-37; multi_modal.py:23-48,65-85)
TARGET_CFGS = {
    "4-mode": dict(learning_iter=1000, mcmc_per_flow_steps=10.0),
    "many-well": dict(learning_iter=2000, mcmc_per_flow_steps=10.0),
    "gaussian-mixture": dict(learning_iter=10_000, mcmc_per_flow_steps=10.0),
}


def _is_stats(log_w):
    log_w = jnp.where(jnp.isfinite(log_w), log_w, -jnp.inf)
    n = log_w.shape[0]
    return (
        float(LSE(log_w) - jnp.log(n)),
        float(jnp.exp(2 * LSE(log_w) - LSE(2 * log_w)) / n),
    )


def run_cell(method, example, seed, cfg, target, n_eval, real):
    """One (method, target, seed) run -> metric row dict."""
    key_eval = jax.random.fold_in(jax.random.PRNGKey(seed), 999)
    if method == "mfm":
        cfg.seed = seed
        t0 = time.time()
        run = run_mfm(target, cfg)
        jax.block_until_ready(run.train.params)
        train_time = run.train_time
        fs, es, log_w = sample_flow(run, key_eval, n_eval, target)
        log_z_is, ess_frac = _is_stats(log_w)
        m = evaluate_samples(target, fs, es, real)
        m.update(log_z_is=log_z_is, is_ess_frac=ess_frac,
                 wall_time_s=time.time() - t0)
    elif method == "smc":
        cfg.seed = seed
        # every showdown target is flat-prior; the geometric bridge makes
        # SMC's log_z a valid estimate of the target normalizer (the
        # reference path's logZ carries a spurious -14.5-nat first term on
        # 4-mode — see config.smc_path / targets.base.GeometricPath)
        cfg.smc_path = "geometric"
        t0 = time.time()
        r = run_smc(target, cfg, key=jax.random.PRNGKey(seed))
        jax.block_until_ready(r.particles)
        train_time = r.train_time
        particles = r.particles[:n_eval]
        m = evaluate_samples(target, particles, particles, real)
        m.update(log_z_is=float(r.log_z), is_ess_frac=None,
                 wall_time_s=time.time() - t0)
    else:  # fab / flowmc / dds via the dispatch (in-repo impls here)
        t0 = time.time()
        res = run_baseline(method, target, cfg, seed=seed, n_eval=n_eval)
        m = evaluate_samples(target, res.flow_samples, res.exact_samples,
                             real)
        m.update(
            log_z_is=res.extras.get("log_z_is"),
            is_ess_frac=res.extras.get("is_ess_frac"),
            wall_time_s=time.time() - t0,
        )
        train_time = res.train_time
    m["train_time_s"] = float(train_time)
    m["seed"] = seed
    return m


def aggregate(cells):
    """mean +/- 1.96 sigma over seeds (reference multi_modal.py:133-143)."""
    keys = [k for k, v in cells[0].items()
            if isinstance(v, (int, float)) and v is not None and k != "seed"]
    out = {}
    for k in keys:
        vals = [c[k] for c in cells if c.get(k) is not None]
        if not vals:
            continue
        out[k] = {
            "mean": float(np.mean(vals)),
            "ci95": float(1.96 * np.std(vals)),
            "n": len(vals),
        }
    return out


def run_showdown(targets, methods, seeds, iters_scale=1.0, out_path=None,
                 resume=True):
    """Run the full (target x method x seed) grid; returns the artifact
    dict. ``out_path`` (optional) is rewritten incrementally after every
    cell so a timeout still leaves a complete partial artifact. With
    ``resume`` (default), an existing artifact at ``out_path`` is loaded
    and ok cells are skipped — so the grid can be driven one
    (target, method) at a time in separate processes and survive device
    faults without losing finished cells."""
    LOGZ_TRUE["many-well"] = quadrature_logz_many_well()
    out = {
        "protocol": {
            "seeds": list(seeds),
            "iters_scale": iters_scale,
            "device": str(jax.devices()[0]),
            "configs": {},
        },
        "cells": {},
        "tables": {},
    }
    if resume and out_path and os.path.exists(out_path):
        with open(out_path) as fh:
            prev = json.load(fh)
        out["cells"].update(prev.get("cells", {}))
        out["tables"].update(prev.get("tables", {}))
        out["protocol"]["configs"].update(
            prev.get("protocol", {}).get("configs", {}))

    def dump():
        if out_path:
            with open(out_path, "w") as fh:
                json.dump(out, fh, indent=2)

    for example in targets:
        tgt_over = dict(TARGET_CFGS[example])
        tgt_over["learning_iter"] = max(
            int(tgt_over["learning_iter"] * iters_scale), 10)
        cfg0 = preset(example, **tgt_over)
        out["protocol"]["configs"][example] = {
            **tgt_over, "num_chain": cfg0.num_chain,
            "step_size": cfg0.step_size, "dim": cfg0.dim,
            "logz_true": LOGZ_TRUE[example],
        }
        target = make_target(example)
        n_eval = cfg0.eval_iter * cfg0.num_chain
        real = target.sample(jax.random.PRNGKey(7), (n_eval,))

        for method in methods:
            cells = []
            for seed in seeds:
                cfg = preset(example, **tgt_over)
                label = f"{example}/{method}/seed{seed}"
                prev_cell = out["cells"].get(label)
                if prev_cell is not None and "error" not in prev_cell:
                    print(f"[showdown] {label}: reusing finished cell",
                          flush=True)
                    cells.append(prev_cell)
                    continue
                t0 = time.time()
                try:
                    m = run_cell(method, example, seed, cfg, target,
                                 n_eval, real)
                except Exception as e:  # record, keep going
                    m = {"error": repr(e)[:500], "seed": seed}
                m["cell_wall_s"] = round(time.time() - t0, 2)
                print(f"[showdown] {label}: "
                      f"{json.dumps({k: v for k, v in m.items() if not isinstance(v, dict)})}",
                      flush=True)
                cells.append(m)
                out["cells"][label] = m
                dump()
            ok = [c for c in cells if "error" not in c]
            if ok:
                agg = aggregate(ok)
                if LOGZ_TRUE[example] is not None and "log_z_is" in agg:
                    agg["log_z_err"] = {
                        "mean": agg["log_z_is"]["mean"] - LOGZ_TRUE[example],
                        "ci95": agg["log_z_is"]["ci95"],
                    }
                out["tables"].setdefault(example, {})[method] = agg
            dump()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="RESULTS_raw_baseline_showdown.json")
    ap.add_argument("--targets", default="4-mode,many-well,gaussian-mixture")
    ap.add_argument("--methods", default="mfm,smc,fab,flowmc,dds")
    ap.add_argument("--seeds", default="0,1,1024")
    ap.add_argument("--iters-scale", type=float, default=1.0,
                    help="scale every learning_iter (budget control; "
                    "recorded in the artifact)")
    args = ap.parse_args()
    run_showdown(
        targets=args.targets.split(","),
        methods=args.methods.split(","),
        seeds=[int(s) for s in args.seeds.split(",")],
        iters_scale=args.iters_scale,
        out_path=args.out,
    )
    print(json.dumps({"showdown_done": True, "out": args.out}))


if __name__ == "__main__":
    main()
