"""Flow-annealed SMC: turn a trained CNF into a *usable weighted sampler*.

The raw self-normalized IS correction (drivers/mfm.sample_flow_parts;
reference exe_flow_matching.py:453-459) is structurally degenerate at high
dim — per-dim flow error × d puts ~12 nats of spread in the log-weights at
pines d=1600 (benchmarks/pines_is_ess.py), so the ESS collapses to a
handful regardless of probe quality. This driver replaces the single
0 → 1 importance jump with **adaptive tempered SMC in the flow's latent
space** (flows/pullback.py): every increment's Δλ is chosen by the ESS
rule so the per-step weights stay healthy *by construction*, resampling
re-concentrates the ensemble, and the inner MCMC moves (in u-space,
through the transport) restore diversity. At λ = 1 the pushed-forward
particles are target samples with non-degenerate weights, plus an
unbiased-flavor log-normalizer estimate the raw IS path cannot give.

Cost model: each tempering step ≈ (2 + num_mcmc_steps) transport
evaluations (ESS solve + reweigh + moves) over the particle batch — a run
of ~20 temperatures costs on the order of a hundred flow-refresh steps of
the training loop.

The inner kernel + in-loop adaptation reuse the SMC driver's machinery
(drivers/smc_run.py): mala | hmc | nuts with dual-averaging step size,
and particle-variance inverse mass for trajectory kernels.
"""

import time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from mfm_tpu.config import MFMConfig
from mfm_tpu.smc import adaptive_tempered_smc, get_resampler
from mfm_tpu.targets.base import Target


class FlowSMCResult(NamedTuple):
    samples: jax.Array  # (N, d) pushed-forward particles at final lambda
    latent: jax.Array  # (N, d) latent-space particles
    weights: jax.Array  # (N,) normalized importance weights
    log_z: jax.Array  # log-normalizer estimate of the (unnormalized) target
    lmbda: jax.Array  # final inverse temperature (1.0 = reached the target)
    ess_fraction: jax.Array  # ESS of ``weights`` / N
    acceptance: jax.Array  # (n_steps,) inner-move mean acceptance
    train_time: float


def ess_fraction_of(weights: jax.Array) -> jax.Array:
    """ESS(w)/N via the shared log-weight implementation (smc/ess.py)."""
    from mfm_tpu.smc import ess as smc_ess

    return smc_ess.ess(jnp.log(weights)) / weights.shape[0]


def _make_latent_tess_builder(ref_dist: Target, max_subiter: int = 30):
    """Gradient-free, tuning-free inner moves: elliptical slice sampling on
    the tempered latent target rho_lambda(u) ∝ q0(u) exp(lambda ell(u)).

    The ellipse prior is q0 itself (any Gaussian with a sampler; ellipses
    rotate about ``ref_dist.gaussian_mean`` / ``.mean`` / 0), and the slice
    "likelihood" is lambda*ell(u) = log rho(u) - log q0(u) — recovered from
    the tempered kernel's value function, so this plugs into the standard
    ``mcmc_kernel_builder(vs, params)`` contract (smc/tempered.py) with the
    (step_size, inv_mass) params simply unused. One batched transport
    evaluation per shrinkage trip, whole-ensemble masked while_loop
    (kernels/tess.py pattern; reference bblackjax/mcmc/tess.py:109-124).
    """
    import jax.numpy as jnp
    from jax import lax

    from mfm_tpu.kernels.base import ChainState

    mean = getattr(ref_dist, "gaussian_mean", None)
    if mean is None:
        mean = getattr(ref_dist, "mean", 0.0)

    def builder(vs, params):
        del params  # step size / mass are meaningless for slice moves

        def slice_l(u):
            vals = vs(u)[0]
            return vals - ref_dist.log_prob(u)  # = lambda * ell(u)

        def kernel(rng_key, chain):
            u0 = chain.position
            B = u0.shape[0]
            key_nu, key_y, key_theta, key_loop = jax.random.split(rng_key, 4)

            nu = ref_dist.sample(key_nu, (B,))
            log_y = slice_l(u0) + jnp.log(jax.random.uniform(key_y, (B,)))

            def ellipse(theta):
                c = jnp.cos(theta)[:, None]
                s = jnp.sin(theta)[:, None]
                return mean + (u0 - mean) * c + (nu - mean) * s

            theta = 2.0 * jnp.pi * jax.random.uniform(key_theta, (B,))
            tmin, tmax = theta - 2.0 * jnp.pi, theta
            u = ellipse(theta)
            s = slice_l(u)

            def cond(carry):
                it, *_, active = carry
                return jnp.any(active) & (it < max_subiter)

            def body(carry):
                it, key, s, subiter, theta, tmin, tmax, u, active = carry
                key, sub = jax.random.split(key)
                prop = jax.random.uniform(sub, (B,), minval=tmin, maxval=tmax)
                theta_new = jnp.where(active, prop, theta)
                u_new = ellipse(theta_new)
                s_new = slice_l(u_new)
                u = jnp.where(active[:, None], u_new, u)
                s = jnp.where(active, s_new, s)
                theta = theta_new
                tmin = jnp.where(active & (theta < 0), theta, tmin)
                tmax = jnp.where(active & (theta > 0), theta, tmax)
                subiter = subiter + active.astype(jnp.int32)
                still = active & ((s <= log_y) | ~jnp.isfinite(s))
                return (it + 1, key, s, subiter, theta, tmin, tmax, u, still)

            active0 = (s <= log_y) | ~jnp.isfinite(s)
            carry = (
                0, key_loop, s, jnp.ones(B, jnp.int32), theta, tmin, tmax, u,
                active0,
            )
            _, _, s, subiter, *_, u, _ = lax.while_loop(cond, body, carry)

            new_chain = ChainState(
                u, s + ref_dist.log_prob(u), jnp.zeros_like(u)
            )
            # slice sampling always moves; report mixing as 1/shrinkage-trips
            info_acc = 1.0 / subiter.astype(u.dtype)
            return new_chain, _TESSMoveInfo(info_acc, subiter)

        return kernel

    def init(positions, vs):
        del vs  # no gradient cache needed
        return ChainState(
            positions,
            jnp.zeros(positions.shape[0], positions.dtype),
            jnp.zeros_like(positions),
        )

    return builder, init


class _TESSMoveInfo(NamedTuple):
    acceptance_rate: jax.Array  # (B,) 1/shrinkage-trips (mixing proxy)
    subiter: jax.Array


def run_flow_smc(
    target: Target,
    cfg: MFMConfig,
    transport,
    params,
    ref_dist: Target,
    key: Optional[jax.Array] = None,
    n_particles: Optional[int] = None,
    n_steps: int = 30,
    num_mcmc_steps: Optional[int] = None,
    inner_kernel: Optional[str] = None,
    steady_timing: bool = False,
    chunk_steps: Optional[int] = None,
) -> FlowSMCResult:
    """Anneal q0 --T--> pi with ``n_steps`` adaptive tempering steps.

    Steps after lambda reaches 1 degrade gracefully into pure MCMC moves on
    the pullback of pi (Δλ = 0 ⇒ uniform incremental weights), so n_steps
    only needs to be an upper bound on the temperature count.

    ``inner_kernel`` (default ``cfg.mcmc_kernel``): mala | hmc | nuts via
    the SMC driver's builders, or ``tess`` — elliptical slice moves on the
    tempered latent target, gradient-free AND tuning-free (no step size
    to adapt; the natural latent-space choice since q0 is the ellipse
    prior). Reference anchor: bblackjax/mcmc/tess.py, here applied to the
    tempered pullback rather than the lambda=1 pullback. Adaptation
    resolves for the EFFECTIVE kernel, and step adaptation defaults ON
    (latent scales are unrelated to cfg.step_size); adapt_step_size=False
    disables it.

    ``steady_timing``: run one full throwaway anneal first so train_time
    is the steady-state device time (benchmark mode — doubles the cost;
    the default times the single run, compile included).
    """
    from mfm_tpu.adaptation.window import da_init, da_update
    from mfm_tpu.drivers.smc_run import _make_kernel_builder
    from mfm_tpu.flows.pullback import FlowPullbackTarget
    from mfm_tpu.kernels import mala
    from mfm_tpu.smc import tempered

    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    n = n_particles or cfg.num_chain
    if cfg.waste_free_p and n % cfg.waste_free_p:
        raise ValueError(
            f"waste_free_p={cfg.waste_free_p} must divide the particle "
            f"count {n}"
        )
    n_mcmc = cfg.iter_per_temp if num_mcmc_steps is None else num_mcmc_steps
    key_init, key_run, key_push = jax.random.split(key, 3)

    kernel_name = inner_kernel or cfg.mcmc_kernel
    if kernel_name == "tess":
        builder, mcmc_init = _make_latent_tess_builder(ref_dist)
        adapt_step = adapt_mass = False  # slice moves have nothing to tune
        target_acc = 0.0  # unused
    else:
        import dataclasses as _dc

        # resolve adaptation for the EFFECTIVE inner kernel (an
        # inner_kernel override must bring its own defaults: nuts gets
        # mass adaptation + 0.8 target even when cfg.mcmc_kernel='mala')
        inner_cfg = _dc.replace(cfg, mcmc_kernel=kernel_name)
        adapt_step, adapt_mass, target_acc = inner_cfg.resolved_adaptation()
        if cfg.adapt_step_size is None:
            # latent-space deviation from the data-space default: the
            # pullback's scale has nothing to do with cfg.step_size, so a
            # fixed-step latent MALA is almost always mistuned — step
            # adaptation defaults ON here unless explicitly disabled
            adapt_step = True
        builder = _make_kernel_builder(inner_cfg)
        mcmc_init = mala.init

    u0 = ref_dist.sample(key_init, (n,))
    state0 = tempered.init(u0)

    def one_step(carry, step_key):
        state, da, inv_mass = carry
        key_probe, key_smc = jax.random.split(step_key)
        # fresh Hutchinson probes each temperature: each tempering step
        # works on a self-consistent surrogate; re-randomizing between
        # steps keeps any single probe's logdet bias from persisting
        latent = FlowPullbackTarget(target, transport, params, ref_dist, key_probe)
        algo = adaptive_tempered_smc(
            latent,
            mcmc_kernel_builder=builder,
            mcmc_init=mcmc_init,
            resample_fn=get_resampler("systematic"),
            target_ess=cfg.alpha,
            num_mcmc_steps=n_mcmc,
            waste_free_p=cfg.waste_free_p,
        )
        step_size = jnp.exp(da.log_step) if adapt_step else cfg.step_size
        im = (
            jnp.maximum(jnp.var(state.particles, axis=0), 1e-6)
            if adapt_mass
            else inv_mass
        )
        state, info = algo.step(key_smc, state, (step_size, im))
        mean_acc = jnp.nan_to_num(jnp.mean(info.update_info), nan=0.0)
        da = da_update(da, mean_acc, target_acc)
        return (state, da, im), (info.log_likelihood_increment, mean_acc)

    @jax.jit
    def run_chunk(carry, keys):
        carry, (log_z_inc, acc) = jax.lax.scan(one_step, carry, keys)
        return carry, jnp.sum(log_z_inc), acc

    # Chunk the anneal into host-level device round-trips (same pattern as
    # drivers/mfm.py cfg.chunk_size). Semantics are identical — the scan
    # carry passes through — but no single XLA execution runs longer than
    # ~256 transport evaluations. Each tempering step costs ~(2 + n_mcmc)
    # transport evals (module docstring). The auto formula assumes the
    # preset 24-step transport — pass ``chunk_steps`` explicitly for
    # costlier transports (finer ODE grids, exact_disc) where an eval is
    # a multiple of that.
    chunk = chunk_steps or max(1, min(n_steps, 256 // (2 + n_mcmc)))
    keys = jax.random.split(key_run, n_steps)

    def run(state0):
        carry = (state0, da_init(cfg.step_size), jnp.ones(cfg.dim))
        log_z = jnp.zeros(())
        accs = []
        for i in range(0, n_steps, chunk):
            carry, lz, acc = run_chunk(carry, keys[i : i + chunk])
            log_z = log_z + lz
            accs.append(acc)
        return carry[0], log_z, jnp.concatenate(accs)

    if steady_timing:
        # benchmark mode: warm-compile with a full throwaway anneal so
        # train_time is the steady-state device time
        warm = run(state0)
        jax.block_until_ready(warm)
    start = time.time()
    state, log_z, acc = run(state0)
    jax.block_until_ready(state)
    train_time = time.time() - start

    samples, _ = transport.forward(params, state.particles, key_push)
    return FlowSMCResult(
        samples,
        state.particles,
        state.weights,
        log_z,
        state.lmbda,
        ess_fraction_of(state.weights),
        acc,
        train_time,
    )
