"""Adaptive tempered SMC baseline driver.

Parity with the reference SMC baseline (/root/reference/exe_others.py:79-111):
adaptive-tempered SMC with an ensemble inner kernel and systematic
resampling, the whole run scanned on device, followed by a sample-harvest
phase of ``eval_iter`` further steps.

Beyond the reference (which hardcodes a fixed-step MALA inner kernel,
exe_others.py:85-94): the inner kernel is selectable (``cfg.mcmc_kernel``:
mala | hmc | nuts) and can self-tune in the loop —

- **step size** by dual averaging on the ensemble-mean inner acceptance,
  carried across tempering steps (the tempered posterior changes slowly in
  lambda, so the previous temperature's step size is the right warm start);
- **inverse mass** (hmc/nuts) from the per-temperature particle variance —
  SMC holds N equally-weighted-ish draws of pi_lambda at every step, so the
  diagonal posterior scale is available for free each temperature, no
  Welford window needed (contrast drivers/mfm.py:244-258).

Defaults keep strict reference parity: MALA at fixed cfg.step_size.
Adaptation resolves through cfg.resolved_adaptation() — on for hmc/nuts,
opt-in for MALA (--set adapt_step_size=true).

``cfg.waste_free_p`` >= 2 switches the move stage to waste-free SMC
(smc/tempered.py): M = N/P resampled ancestors, P - 1 moves each, every
intermediate state kept — a lower-variance logZ at the same move budget.
"""

import time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from mfm_tpu.config import MFMConfig
from mfm_tpu.kernels import mala
from mfm_tpu.smc import adaptive_tempered_smc, get_resampler
from mfm_tpu.targets.base import Target


class SMCRunResult(NamedTuple):
    particles: jax.Array  # (eval_iter * n_chain, d) harvested samples
    lmbda: jax.Array
    log_z: jax.Array  # accumulated log-normalizer estimate
    train_time: float


def _make_kernel_builder(cfg: MFMConfig):
    """mcmc_kernel_builder(vs, (step_size, inv_mass)) for the tempered
    kernel's pass-through (smc/tempered.py)."""
    if cfg.mcmc_kernel == "mala":

        def builder(vs, params):
            step_size, _ = params
            k = mala.build_kernel(vs)
            return lambda key, s: k(key, s, step_size)

    elif cfg.mcmc_kernel == "hmc":
        from mfm_tpu.kernels import hmc

        def builder(vs, params):
            step_size, inv_mass = params
            k = hmc.build_kernel(vs)
            return lambda key, s: k(
                key, s, step_size, cfg.hmc_num_integration_steps, inv_mass
            )

    elif cfg.mcmc_kernel == "nuts":
        from mfm_tpu.kernels import nuts

        def builder(vs, params):
            step_size, inv_mass = params
            k = nuts.build_kernel(vs, cfg.nuts_max_depth, variant=cfg.nuts_variant)
            return lambda key, s: k(key, s, step_size, inv_mass)

    else:
        raise ValueError(f"unknown mcmc_kernel {cfg.mcmc_kernel!r}")
    return builder


def run_smc(
    target: Target,
    cfg: MFMConfig,
    key: Optional[jax.Array] = None,
    resampler: str = "systematic",
) -> SMCRunResult:
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    key_init, key_run, key_harvest = jax.random.split(key, 3)

    if cfg.smc_path == "geometric":
        # valid logZ for flat-prior targets: temper along the geometric
        # bridge N(0,I)^(1-beta) p^beta instead of the reference's improper
        # flat-prior path (see targets.base.GeometricPath / config.smc_path)
        from mfm_tpu.targets.base import GeometricPath

        target = GeometricPath(target)
    elif cfg.smc_path != "reference":
        raise ValueError(f"unknown smc_path {cfg.smc_path!r}")

    adapt_step, adapt_mass, target_acc = cfg.resolved_adaptation()
    builder = _make_kernel_builder(cfg)

    # sharded particle ensemble: cfg.mesh_shape plugs in the shard_map
    # distributed resampler + ppermute ring gather, keeping the whole SMC
    # step free of particle-matrix all-gathers (smc/distributed.py; the
    # local jit path stays the single-chip default)
    resample_fn = get_resampler(resampler)
    gather_fn = None
    mesh = None
    if cfg.mesh_shape is not None:
        from mfm_tpu.parallel import make_mesh
        from mfm_tpu.smc.distributed import (
            make_distributed_gather,
            make_distributed_resampler,
        )

        axis_names = ("ensemble", "chains")[-len(cfg.mesh_shape):]
        mesh = make_mesh(tuple(cfg.mesh_shape), axis_names)
        if resampler in ("systematic", "stratified"):
            resample_fn = make_distributed_resampler(resampler, mesh)
            gather_fn = make_distributed_gather(mesh)

    if cfg.waste_free_p:
        if cfg.num_chain % cfg.waste_free_p:
            raise ValueError(
                f"waste_free_p={cfg.waste_free_p} must divide "
                f"num_chain={cfg.num_chain}"
            )
        if mesh is not None:
            n_shards = mesh.devices.size
            if (cfg.num_chain // cfg.waste_free_p) % n_shards:
                raise ValueError(
                    "waste-free under a mesh needs num_chain/waste_free_p "
                    f"divisible by the shard count ({n_shards})"
                )

    algo = adaptive_tempered_smc(
        target,
        mcmc_kernel_builder=builder,
        mcmc_init=mala.init,
        resample_fn=resample_fn,
        target_ess=cfg.alpha,
        num_mcmc_steps=cfg.iter_per_temp,
        gather_fn=gather_fn,
        waste_free_p=cfg.waste_free_p,
    )

    init_positions = target.init_positions(key_init, cfg.num_chain)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        init_positions = jax.device_put(
            init_positions, NamedSharding(mesh, P("chains"))
        )
    state = algo.init(init_positions)

    from mfm_tpu.adaptation.window import da_init, da_update

    def mcmc_params_of(da, inv_mass, particles):
        step_size = jnp.exp(da.log_step) if adapt_step else cfg.step_size
        if adapt_mass:
            # per-temperature posterior scale straight off the particle block
            inv_mass = jnp.maximum(jnp.var(particles, axis=0), 1e-6)
        return (step_size, inv_mass), inv_mass

    def adapted_step(carry, k):
        state, da, inv_mass = carry
        params, inv_mass = mcmc_params_of(da, inv_mass, state.particles)
        state, info = algo.step(k, state, params)
        # update_info stacks the inner scan's acceptance —
        # (num_mcmc_steps, N) standard, (P-1, N/P) waste-free — and dual
        # averaging consumes the mean either way
        mean_acc = jnp.nan_to_num(jnp.mean(info.update_info), nan=0.0)
        da = da_update(da, mean_acc, target_acc)
        return (state, da, inv_mass), info

    carry0 = (state, da_init(cfg.step_size), jnp.ones(cfg.dim))

    @jax.jit
    def run_phase_chunk(c, keys):
        """Tempering phase: no particle history is materialized."""

        def body(c, k):
            carry, logz = c
            carry, info = adapted_step(carry, k)
            return (carry, logz + info.log_likelihood_increment), None

        return jax.lax.scan(body, c, keys)[0]

    def run_phase(carry, keys):
        # host-chunked (cfg.chunk_size steps per device round-trip, the
        # drivers/mfm.py pattern): the 10k-step benchmark configs would
        # otherwise run as one call
        c = (carry, jnp.zeros(()))
        n = keys.shape[0]
        chunk = max(1, min(cfg.chunk_size, n))
        for i in range(0, n, chunk):
            c = run_phase_chunk(c, keys[i : i + chunk])
        return c

    @jax.jit
    def harvest_phase(carry, keys):
        """Sample harvest: keep per-step particles (exe_others.py:108-111)."""

        def body(carry, k):
            carry, _ = adapted_step(carry, k)
            return carry, carry[0].particles

        return jax.lax.scan(body, carry, keys)

    # entire tempering run is one on-device scan (the reference jits the
    # step but already scans, exe_others.py:96-104); warm-compile first so
    # train_time is steady-state
    run_keys = jax.random.split(key_run, cfg.learning_iter)
    warm = run_phase(carry0, run_keys)
    jax.block_until_ready(warm)
    start = time.time()
    carry, log_z = run_phase(carry0, run_keys)
    jax.block_until_ready(carry)
    train_time = time.time() - start

    harvest_keys = jax.random.split(key_harvest, cfg.eval_iter)
    _, particle_hist = harvest_phase(carry, harvest_keys)
    samples = particle_hist.reshape(-1, cfg.dim)
    return SMCRunResult(samples, carry[0].lmbda, log_z, train_time)
