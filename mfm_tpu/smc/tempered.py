"""Tempered SMC over pi_lambda(x) ∝ exp(logprior + lambda * loglik).

Parity with /root/reference/bblackjax/smc/tempered.py. batched redesign of
the inner move: the reference scans ``num_mcmc_steps`` of a scalar MCMC
kernel *per particle* under vmap (tempered.py:130-141); here the **ensemble
kernel steps the whole particle block**, so the inner loop is a scan of
batched (N, d) kernel applications — each one a fused batched
gradient + proposal + accept pass.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from mfm_tpu.kernels.base import SamplingAlgorithm
from mfm_tpu.smc import base as smc_base
from mfm_tpu.targets.base import Target


class TemperedSMCState(NamedTuple):
    particles: jax.Array
    weights: jax.Array
    lmbda: jax.Array  # current inverse temperature in [0, 1]


def init(particles: jax.Array) -> TemperedSMCState:
    n = particles.shape[0]
    return TemperedSMCState(
        particles, jnp.full((n,), 1.0 / n, particles.dtype), jnp.zeros(())
    )


def build_kernel(
    target: Target,
    mcmc_kernel_builder: Callable,
    mcmc_init: Callable,
    resample_fn: Callable,
    num_mcmc_steps: int = 10,
    gather_fn=None,
    waste_free_p: int = 0,
) -> Callable:
    """Build the tempered SMC kernel.

    mcmc_kernel_builder(value_and_score) -> ensemble kernel
        kernel(key, chain_state) -> (chain_state, info)
    mcmc_init(positions, value_and_score) -> chain_state

    When the per-step call supplies ``mcmc_params`` (any pytree — e.g.
    a traced (step_size, inverse_mass) tuple from an in-loop adaptation
    carry), the builder is called as ``mcmc_kernel_builder(vs, mcmc_params)``
    so kernel hyperparameters can change across tempering steps without
    retracing (drivers/smc_run.py uses this for dual averaging).

    ``waste_free_p`` >= 2 switches the move stage to **waste-free SMC**
    (Dau & Chopin 2022): resample only M = N / P ancestors, run each P-1
    inner moves, and keep *every* intermediate chain state — the new
    N-particle system is the M chains of length P, all reweighed by the
    same tempering increment (every state is marginally pi_{lambda_prev}-
    distributed, so the bridge weight applies uniformly). Same move
    budget as ``num_mcmc_steps = P - 1`` standard SMC, but no sample is
    discarded — the intermediate states that plain SMC throws away
    become support points of the next importance approximation. This
    exercises the ``num_resampled`` hook of smc/base.py (reference
    bblackjax/smc/base.py:99-103, which declares the hook but never uses
    it). ``num_mcmc_steps`` is ignored when waste-free is on.
    """
    if waste_free_p == 1:
        raise ValueError(
            "waste_free_p=1 means zero inner moves per ancestor; "
            "use 0 to disable waste-free SMC or >= 2 to enable it"
        )

    def kernel(rng_key: jax.Array, state: TemperedSMCState, lmbda, mcmc_params=None):
        delta = lmbda - state.lmbda

        # batched value-and-grad of the tempered posterior at the *current*
        # lambda (the MCMC moves target pi_{lambda_prev}; reweighing bridges
        # to lambda, reference tempered.py:122-128). Delegates to the target,
        # which may provide an analytic/fused batched path (LGCP's
        # precision-GEMM score; the flow-pullback target's single-ODE-solve
        # value-and-grad) instead of the default vmapped autodiff.
        def vs(x):
            return target.tempered_value_and_score(x, state.lmbda)

        if mcmc_params is None:
            inner = mcmc_kernel_builder(vs)
        else:
            inner = mcmc_kernel_builder(vs, mcmc_params)

        num_resampled = None
        if waste_free_p:
            n_total = state.particles.shape[0]
            if n_total % waste_free_p:
                raise ValueError(
                    f"waste-free SMC needs num_chain divisible by "
                    f"waste_free_p; got N={n_total}, P={waste_free_p}"
                )
            num_resampled = n_total // waste_free_p

            def update_fn(key, particles):
                m, d = particles.shape
                chain = mcmc_init(particles, vs)

                def body(carry, k):
                    new, info = inner(k, carry)
                    return new, (new.position, info.acceptance_rate)

                keys = jax.random.split(key, waste_free_p - 1)
                _, (hist, acc) = jax.lax.scan(body, chain, keys)
                # (P, M, d) -> (M, P, d) -> (M*P, d): chain-major order
                # keeps each ancestor's P states contiguous, so a sharded
                # M axis expands shard-locally (no cross-device reshuffle)
                allp = jnp.concatenate([particles[None], hist], axis=0)
                allp = jnp.swapaxes(allp, 0, 1).reshape(m * waste_free_p, d)
                return allp, acc

        else:

            def update_fn(key, particles):
                chain = mcmc_init(particles, vs)

                def body(carry, k):
                    new, info = inner(k, carry)
                    return new, info.acceptance_rate

                keys = jax.random.split(key, num_mcmc_steps)
                chain, acc = jax.lax.scan(body, chain, keys)
                return chain.position, acc

        def weigh_fn(particles):
            return delta * target.log_lik(particles)

        smc_state, info = smc_base.step(
            rng_key,
            smc_base.SMCState(state.particles, state.weights),
            update_fn,
            weigh_fn,
            resample_fn,
            num_resampled=num_resampled,
            gather_fn=gather_fn,
        )
        new_state = TemperedSMCState(
            smc_state.particles, smc_state.weights, state.lmbda + delta
        )
        return new_state, info

    return kernel


def tempered_smc(
    target: Target,
    mcmc_kernel_builder: Callable,
    mcmc_init: Callable,
    resample_fn: Callable,
    num_mcmc_steps: int = 10,
    gather_fn=None,
    waste_free_p: int = 0,
) -> SamplingAlgorithm:
    kernel = build_kernel(
        target, mcmc_kernel_builder, mcmc_init, resample_fn, num_mcmc_steps,
        gather_fn, waste_free_p,
    )

    def step_fn(rng_key, state, lmbda, mcmc_params=None):
        return kernel(rng_key, state, lmbda, mcmc_params)

    return SamplingAlgorithm(init, step_fn)
