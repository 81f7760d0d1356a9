"""Run the UNMODIFIED reference implementation as a baseline.

Imports the read-only reference tree at /root/reference with no-op /
minimal shims for its unavailable dependencies (wandb, jaxopt, diffrax —
see ref_shims/), reproduces the 4-mode configuration of multi_modal.py
(:65-85 overrides, :148-219 defaults), and reports the reference's own
post-JIT train_time plus final metrics computed by its own eval block.

Usage:
    python benchmarks/run_reference.py [--platform cpu|cuda] \
        [--learning-iter 1000] [--seed 0] [--x64]

The reference defaults to float64 (multi_modal.py:14), which is slow on
an accelerator, so --x64 is meant for CPU runs.
"""

import argparse
import json
import os
import sys
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default="cpu", choices=["cpu", "cuda"])
    p.add_argument("--example", default="4-mode",
                   choices=["4-mode", "gaussian-mixture", "phi-four", "pines"])
    p.add_argument("--learning-iter", type=int, default=1000)
    p.add_argument("--mcmc-per-flow-steps", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hutchs", action="store_true")
    p.add_argument("--do-smc", action="store_true")
    p.add_argument("--x64", action="store_true", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    os.environ["JAX_PLATFORMS"] = args.platform
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "ref_shims"))
    sys.path.insert(0, "/root/reference")

    import jax

    # compat shim: the reference targets jax 0.4.x whose jax.tree_map alias
    # was removed in jax 0.9 (used by its smc/base.py)
    if not hasattr(jax, "tree_map"):
        jax.tree_map = jax.tree_util.tree_map

    use_x64 = args.x64 if args.x64 is not None else (args.platform == "cpu")
    if use_x64:
        jax.config.update("jax_enable_x64", True)  # reference multi_modal.py:14

    import jax.numpy as jnp

    from distributions import GaussianMixture, PhiFour  # reference, read-only
    import exe_flow_matching  # reference orchestrator

    hidden = [128, 128]
    if args.example == "gaussian-mixture":
        # 16 random modes seeded with PRNGKey(0) (reference multi_modal.py:39-47)
        key_mode, key_cov, key_weight = jax.random.split(jax.random.PRNGKey(0), 3)
        modes = jax.random.uniform(key_mode, (16, 2), minval=-12.8, maxval=12.8)
        covs = jnp.exp(0.5 * jax.random.normal(key_cov, (16, 2)))
        weights = jax.random.dirichlet(key_weight, 4.0 * jnp.ones(16))
        dist = GaussianMixture(modes, covs, weights)
        dim, num_chain, step_size, eval_iter = 2, 128, 0.2, 100
    elif args.example == "4-mode":
        # the 4-mode setup (reference multi_modal.py:65-85)
        modes = 8.0 * jnp.array([[1, 1], [1, -1], [-1, 1], [-1, -1]])
        covs = jnp.ones((4, 2))
        weights = jnp.ones(4) / 4
        dist = GaussianMixture(modes, covs, weights)
        dim, num_chain, step_size, eval_iter = 2, 128, 0.2, 100
    elif args.example == "phi-four":
        # phi-four setup (reference multi_modal.py:50-63)
        dist = PhiFour(64)
        dist.sample_model = None
        dim, num_chain, step_size, eval_iter = 64, 1024, 1e-4, 1
    else:
        # pines setup (reference multi_modal.py:87-98)
        from distributions import LogGaussianCoxPines

        dist = LogGaussianCoxPines(1600, file_path="/root/reference/finpines.csv")
        dist.sample_model = None
        dim, num_chain, step_size, eval_iter = 1600, 128, 0.01, 1
        hidden = [1024, 1024]

    # argparse defaults (reference multi_modal.py:148-219) + 4-mode overrides
    ns = argparse.Namespace(
        seed=args.seed, dim=dim, num_modes=4, example=args.example, sigma=1e-4,
        fourier_dim=128, fourier_std=1.0, hutchs=args.hutchs, ref_dist="stdgauss",
        cond_flow=True, ot_cond_flow=False, num_importance_samples=0,
        mcmc_per_flow_steps=args.mcmc_per_flow_steps, num_chain=num_chain,
        learning_iter=args.learning_iter, eval_iter=eval_iter, alpha=0.95,
        anneal_iter=200, num_anneal_temp=200, non_linearity="relu",
        hidden_x=hidden, hidden_t=hidden, hidden_xt=hidden,
        step_size=step_size, learning_rate=1e-3, weight_decay=1e-4,
        adam_beta1=0.9, adam_beta2=0.999, adam_epsilon=1e-8,
        gradient_clip=1.0, warmup_steps=0, rtol=1e-5, atol=1e-5, mxstep=1000,
        lim=[-1.6, 1.6] if args.example == "phi-four" else [-16, 16],
        grid_width=400, levels=20, check=False,
        do_flowmc=False, do_pocomc=False, do_dds=False, do_smc=args.do_smc,
        do_fab=False,
    )

    start = time.time()
    if args.do_smc:
        import exe_others

        res_flow, res_exact = exe_others.run(dist, ns, dist.sample_model)
    else:
        res_flow, res_exact = exe_flow_matching.run(dist, ns, dist.sample_model)
    wall = time.time() - start

    out = {
        "platform": args.platform,
        "x64": bool(use_x64),
        "learning_iter": args.learning_iter,
        # reference row layout: [logpdf, stein_u, stein_v, mmd, train_time]
        "flow": [float(v) for v in res_flow],
        "exact": [float(v) for v in res_exact],
        "wall_total": wall,
    }
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)


if __name__ == "__main__":
    main()
