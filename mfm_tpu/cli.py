"""Command-line experiment driver.

Parity with the reference CLI (/root/reference/multi_modal.py): the same
four benchmark examples with their per-example overrides, the 10-seed
replication rule (seeds i^10 when --seed is unset, :118), mean +/- 1.96
sigma aggregation printed as a LaTeX-ish row (:133-143), and the baseline
switches. Every baseline switch always works: FAB / flowMC / DDS
(reference exe_others.py) run the external package's adapter when that
package is importable and otherwise the in-repo implementations
(drivers/{fab,flowmc,dds}.py); adaptive tempered SMC (--do-smc) is
in-repo by construction.

Usage:
    python -m mfm_tpu.cli --example 4-mode --mcmc-per-flow-steps 10
    python -m mfm_tpu.cli --example phi-four --do-smc
"""

import argparse
import logging

import jax
import jax.numpy as jnp

from mfm_tpu.config import preset
from mfm_tpu.drivers import evaluate_samples, run_mfm, run_smc, sample_flow
from mfm_tpu.targets import (
    Funnel,
    LogGaussianCoxPines,
    ManyWell,
    PhiFour,
    four_mode_mixture,
    random_mixture,
)
from mfm_tpu.utils.logging import MetricLogger


def make_target(example: str):
    if example == "4-mode":
        return four_mode_mixture()
    if example == "gaussian-mixture":
        return random_mixture()
    if example == "phi-four":
        return PhiFour(64)
    if example == "pines":
        return LogGaussianCoxPines(1600)
    if example == "funnel":
        return Funnel(10)
    if example == "many-well":
        return ManyWell(32)
    raise ValueError(f"unknown example {example!r}")


def run_one(target, cfg, args):
    """One seed: train, sample, evaluate. Returns (flow_row, exact_row)."""
    log = MetricLogger(
        run_dir=args.run_dir,
        run_name=f"{cfg.example}-seed{cfg.seed}",
        use_wandb=args.wandb,
        wandb_kwargs={
            "project": cfg.example,
            "group": f"dim={cfg.dim}",
            "job_type": f"mcmc_per_flow_steps={cfg.mcmc_per_flow_steps}",
        },
    )
    key = jax.random.PRNGKey(cfg.seed)
    key_eval = jax.random.fold_in(key, 999)

    real_samples = None
    n_eval = cfg.eval_iter * cfg.num_chain
    if target.can_sample:
        real_samples = target.sample(jax.random.fold_in(key, 1000), (n_eval,))

    baseline = next(
        (n for n in ("fab", "flowmc", "dds") if getattr(args, f"do_{n}", False)),
        None,
    )
    run = None  # MFMRun when the plain MFM path executes (plots/full metrics)
    if args.do_smc:
        result = run_smc(target, cfg)
        flow_samples = exact_samples = result.particles
        train_time = result.train_time
        log.log({"lmbda": float(result.lmbda), "log_z": float(result.log_z)})
    elif baseline is not None:
        from mfm_tpu.drivers.baselines import run_baseline

        result = run_baseline(baseline, target, cfg, seed=cfg.seed, n_eval=n_eval)
        flow_samples, exact_samples = result.flow_samples, result.exact_samples
        train_time = result.train_time
    else:
        run = run_mfm(target, cfg, logger=log)
        train_time = run.train_time
        if getattr(args, "move_correct", 0) and not getattr(args, "flow_smc", 0):
            # row 1 = the IS-resampled set, row 2 (* columns) = after the
            # MCMC move correction (drivers.sample_flow_move)
            from mfm_tpu.drivers import sample_flow_move

            moved, is_resampled, _ = sample_flow_move(
                run, key_eval, n_eval, target, n_moves=args.move_correct,
                init_step=cfg.step_size,
            )
            flow_samples, exact_samples = is_resampled, moved
        elif getattr(args, "flow_smc", 0):
            # row 1 = raw flow push-forward, row 2 (* columns) = the
            # flow-annealed SMC ensemble (drivers.flow_smc), resampled by
            # its final weights when lambda stopped short of 1
            from mfm_tpu.drivers.flow_smc import run_flow_smc

            key_flow, key_smc, key_pick = jax.random.split(key_eval, 3)
            flow_samples, _, _ = sample_flow(run, key_flow, n_eval, target)
            r = run_flow_smc(
                target, cfg, run.transport, run.train.params, run.ref_dist,
                key=key_smc, n_particles=n_eval, n_steps=args.flow_smc,
            )
            idx = jax.random.categorical(
                key_pick, jnp.log(r.weights), shape=(n_eval,)
            )
            exact_samples = r.samples[idx]
            if getattr(args, "move_correct", 0):
                # composition: the annealed ensemble seeds the move kernel
                # (best of both — flow-SMC's logZ + the move correction's
                # KSD floor)
                from mfm_tpu.drivers.mfm import mala_move_correct

                exact_samples = mala_move_correct(
                    exact_samples, target, jax.random.fold_in(key_pick, 1),
                    n_moves=args.move_correct, init_step=cfg.step_size,
                )
            log.log({
                "flow_smc_log_z": float(r.log_z),
                "flow_smc_lmbda": float(r.lmbda),
                "flow_smc_ess_fraction": float(r.ess_fraction),
            })
        elif getattr(args, "defensive_alpha", 1.0) < 1.0:
            from mfm_tpu.drivers.mfm import sample_flow_defensive
            from mfm_tpu.targets import IndepGaussian

            flow_samples, exact_samples, _ = sample_flow_defensive(
                run, key_eval, n_eval, target,
                IndepGaussian(cfg.dim, var=args.defensive_var),
                alpha=args.defensive_alpha,
            )
        else:
            flow_samples, exact_samples, _ = sample_flow(
                run, key_eval, n_eval, target
            )

    if args.check and real_samples is not None:
        from mfm_tpu.drivers import check_floor

        log.summary(check_floor(target, real_samples))

    metrics = evaluate_samples(target, flow_samples, exact_samples, real_samples)
    metrics["train_time"] = train_time
    log.summary(metrics)
    if getattr(args, "plots", False):
        from mfm_tpu.drivers.plots import make_run_figures

        figs = make_run_figures(
            target, cfg, flow_samples, exact_samples, run=run, key=key_eval
        )
        log.log_figures(figs)
    if getattr(args, "full_metrics", False) and run is not None:
        log.log_per_iteration(run.metrics)
    log.finish()
    flow_row = [
        metrics["logpdf"], metrics["stein_u"], metrics["stein_v"],
        metrics["mmd"], train_time,
    ]
    exact_row = [
        metrics["logpdf_star"], metrics["stein_u_star"], metrics["stein_v_star"],
        metrics["mmd_star"], train_time,
    ]
    return flow_row, exact_row


def run_seeds_vmapped(target, cfg, seeds, args):
    """All seeds trained as one vmapped program; per-seed evaluation."""

    from mfm_tpu.drivers import run_mfm_seeds
    from mfm_tpu.drivers.mfm import field_net, sample_flow_parts
    from mfm_tpu.flows import make_transport
    from mfm_tpu.targets import make_ref_dist

    sweep = run_mfm_seeds(target, cfg, seeds)
    per_seed_time = sweep.train_time / len(seeds)
    if cfg.ref_dist == "prior":
        from mfm_tpu.targets.base import PriorReference

        ref_dist = PriorReference(target)
    else:
        ref_dist = make_ref_dist(cfg.ref_dist, cfg.dim)
    n_eval = cfg.eval_iter * cfg.num_chain
    real_samples = None
    if target.can_sample:
        real_samples = target.sample(jax.random.PRNGKey(1000), (n_eval,))

    rows, rows_exact = [], []
    for i, seed in enumerate(seeds):
        net = field_net(target, cfg, sweep.fourier[i])
        transport = make_transport(
            net.apply, divergence=cfg.divergence,
            n_steps=cfg.eval_ode_steps or cfg.ode_steps,
            method=cfg.ode_method,
            num_probes=cfg.eval_hutchinson_probes,
            probe_dist=cfg.eval_probe_dist,
        )
        params_i = jax.tree_util.tree_map(lambda p: p[i], sweep.params)
        fs, es, _ = sample_flow_parts(
            transport, params_i, ref_dist,
            jax.random.fold_in(jax.random.PRNGKey(seed), 999), n_eval, target,
        )
        m = evaluate_samples(target, fs, es, real_samples)
        rows.append([m["logpdf"], m["stein_u"], m["stein_v"], m["mmd"], per_seed_time])
        rows_exact.append(
            [m["logpdf_star"], m["stein_u_star"], m["stein_v_star"],
             m["mmd_star"], per_seed_time]
        )
    return rows, rows_exact


def main(argv=None):
    from mfm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        level=logging.INFO,
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--example", default="4-mode",
                   choices=["4-mode", "gaussian-mixture", "phi-four", "pines",
                            "funnel", "many-well"])
    p.add_argument("--seed", type=int, default=None,
                   help="single seed; default replicates seeds i**10, i<10")
    p.add_argument("--mcmc-per-flow-steps", type=float, default=10.0)
    p.add_argument("--learning-iter", type=int, default=None)
    p.add_argument("--num-chain", type=int, default=None)
    p.add_argument("--num-importance-samples", type=int, default=0)
    p.add_argument("--hutchs", action="store_true")
    p.add_argument("--step-size", type=float, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--ref-dist", default=None,
               help="flow reference (default: preset choice)")
    p.add_argument("--no-cond-flow", action="store_true")
    p.add_argument("--ot-cond-flow", action="store_true")
    p.add_argument("--ode-steps", type=int, default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--check", action="store_true")
    p.add_argument("--do-smc", action="store_true")
    p.add_argument("--do-fab", action="store_true")
    p.add_argument("--do-flowmc", action="store_true")
    p.add_argument("--do-dds", action="store_true")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--run-dir", default="runs")
    p.add_argument("--chunk-size", type=int, default=None)
    p.add_argument("--mcmc-kernel", default="mala", choices=["mala", "hmc", "nuts"])
    p.add_argument("--vmap-seeds", action="store_true",
                   help="run all replication seeds as one vmapped program "
                        "(training only; evaluation falls back per seed)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any MFMConfig field (repeatable), e.g. "
                        "--set mcmc_kernel=nuts --set eval_hutchinson_probes=8")
    p.add_argument("--move-correct", type=int, default=0, metavar="N",
                   help="after IS resampling, run N self-tuning MALA moves on "
                        "the exact target (repairs IS degeneracy at high dim; "
                        "pines d=1600: KSD-U 2813 -> 0.048 at N=100)")
    p.add_argument("--plots", action="store_true",
                   help="save the reference's end-of-run figure set (pair "
                        "scatters, phi-four fields, 2-D flow progression) "
                        "as PNGs under the run dir; attached to wandb when "
                        "--wandb is on (reference exe_flow_matching.py:"
                        "492-559)")
    p.add_argument("--full-metrics", action="store_true",
                   help="dump per-ITERATION training metrics (loss/LR/"
                        "acceptance/beta) to the JSONL/wandb stream instead "
                        "of discarding them at chunk granularity; the scan "
                        "already stacks them, so this costs one host "
                        "transfer at the end")
    p.add_argument("--flow-smc", type=int, default=0, metavar="N",
                   help="replace the final IS correction with N adaptive "
                        "flow-annealed SMC steps in the flow's latent space "
                        "(* columns become the annealed weighted ensemble; "
                        "also logs the log-normalizer estimate)")
    p.add_argument("--defensive-alpha", type=float, default=1.0,
                   help="final-IS proposal mixture weight on the flow: "
                        "q = a*q_flow + (1-a)*N(0, defensive_var*I). "
                        "a < 1 bounds every importance weight at "
                        "pi/((1-a) q_def), repairing the heavy-tailed-"
                        "weight finite-N logZ tilt (RESULTS.md round 5); "
                        "default 1.0 = pure flow (reference behavior)")
    p.add_argument("--defensive-var", type=float, default=4.0,
                   help="variance of the defensive component (with "
                        "--defensive-alpha < 1)")
    args = p.parse_args(argv)

    non_mfm = [
        flag for flag in ("do_smc", "do_fab", "do_flowmc", "do_dds")
        if getattr(args, flag)
    ]
    if args.vmap_seeds and any(f != "do_smc" for f in non_mfm):
        raise SystemExit(
            "--vmap-seeds only applies to the MFM sampler; drop it or the "
            f"baseline flag ({', '.join('--' + f.replace('_', '-') for f in non_mfm)})"
        )
    if args.move_correct and (non_mfm or args.vmap_seeds):
        raise SystemExit(
            "--move-correct applies only to the plain MFM run (the * "
            "columns of baselines/SMC/vmapped sweeps are not move-"
            "corrected); drop one of the conflicting flags"
        )
    if args.flow_smc and (non_mfm or args.vmap_seeds):
        raise SystemExit(
            "--flow-smc applies only to the plain MFM run and replaces the "
            "final correction; drop the conflicting flag "
            "(baseline/--vmap-seeds). It DOES compose with --move-correct "
            "(annealed ensemble seeds the move kernel)."
        )

    # --do-fab/--do-flowmc/--do-dds always work: drivers.baselines falls
    # back to the in-repo implementations (drivers/{fab,flowmc,dds}.py)
    # when the external packages are absent

    overrides = {"mcmc_per_flow_steps": args.mcmc_per_flow_steps,
                 "num_importance_samples": args.num_importance_samples}
    if args.ref_dist is not None:
        overrides["ref_dist"] = args.ref_dist
    if args.hutchs:
        overrides["hutchinson"] = True
    if args.no_cond_flow:
        overrides["cond_flow"] = False
    if args.ot_cond_flow:
        overrides["ot_cond_flow"] = True
    for name in ["learning_iter", "num_chain", "step_size", "learning_rate",
                 "ode_steps", "alpha", "chunk_size"]:
        val = getattr(args, name)
        if val is not None:
            overrides[name] = val

    overrides["mcmc_kernel"] = args.mcmc_kernel
    import ast
    import dataclasses as _dc

    from mfm_tpu.config import MFMConfig as _Cfg

    settable = {f.name for f in _dc.fields(_Cfg)}  # excludes read-only props
    for item in args.set:
        key, eq, raw = item.partition("=")
        if not eq or key not in settable:
            raise SystemExit(f"--set: unknown config field {key!r}")
        lowered = raw.strip().lower()
        if lowered in ("true", "false"):  # shell-style booleans
            value = lowered == "true"
        elif lowered in ("none", "null"):
            value = None
        else:
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw  # plain string (e.g. ref_dist=prior)
        overrides[key] = value
    cfg = preset(args.example, **overrides)
    target = make_target(args.example)

    seeds = [args.seed] if args.seed is not None else [i**10 for i in range(10)]
    rows, rows_exact = [], []
    if args.vmap_seeds and not args.do_smc:
        rows, rows_exact = run_seeds_vmapped(target, cfg, seeds, args)
    else:
        for seed in seeds:
            cfg.seed = seed
            fr, er = run_one(target, cfg, args)
            rows.append(fr)
            rows_exact.append(er)

    import numpy as np

    job = "SMC" if args.do_smc else (
        f"mcmc_per_flow_steps={cfg.mcmc_per_flow_steps},"
        f"learning_iter={cfg.learning_iter}"
        + (",hutchs" if cfg.hutchinson else "")
    )
    print(job)
    print("-" * 100)
    print("logprob\t & stein-u\t & stein-v\t & mmd  \t & time \t")
    for data in (np.asarray(rows), np.asarray(rows_exact)):
        mean, std = data.mean(axis=0), data.std(axis=0)
        print(*[f"{m:.2e} \\pm {s * 1.96:.2e}" for m, s in zip(mean, std)],
              sep="$ & $")
    print("-" * 100)


if __name__ == "__main__":
    main()
