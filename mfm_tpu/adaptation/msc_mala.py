"""Markovian score climbing with MALA-refreshed flow proposals.

Parity with /root/reference/bblackjax/adaptation/msc_mala.py: each step draws
fresh positions by pushing reference noise through the current flow, runs
``num_mala_samples`` MALA steps from them, and climbs the flow objective on
the resulting chain positions.

Batched: the fresh draw + MALA refinement is ensemble-batched — the flow
push-forward is one batched transport, the inner MALA loop is a scanned
ensemble kernel.
"""

from typing import Callable

import jax

from mfm_tpu.adaptation.msc import chain_adaptation, optimize
from mfm_tpu.kernels import mala
from mfm_tpu.kernels.base import AdaptationAlgorithm


def msc_mala(
    value_and_score: Callable,
    optimizer,
    init_params,
    flow: Callable,
    loss_fn: Callable,
    num_chain: int,
    step_size: float,
    num_steps: int = 1000,
    n_opt_iter: int = 1,
    num_mala_samples: int = 1,
) -> AdaptationAlgorithm:
    """value_and_score: batched (B, d) -> ((B,), (B, d)) of the target."""
    mala_kernel = mala.build_kernel(value_and_score)

    def kernel_factory(params, opt_state):
        def kernel_fn(rng_key, state):
            key_init, key_sample = jax.random.split(rng_key)
            noise = jax.random.normal(
                key_init, state.position.shape, state.position.dtype
            )
            fresh_position = flow(noise, params)[0]
            fresh = mala.init(fresh_position, value_and_score)

            def body(carry, k):
                new, info = mala_kernel(k, carry, step_size)
                return new, info

            keys = jax.random.split(key_sample, num_mala_samples)
            return jax.lax.scan(body, fresh, keys)

        return kernel_fn

    def parameter_gn(states, step, params, opt_state):
        (params, opt_state), _ = optimize(
            params, opt_state, loss_fn, optimizer, n_opt_iter,
            positions=states.position,
        )
        return params, opt_state

    init_adapt, update = chain_adaptation.cross_chain(
        kernel_factory, parameter_gn, num_chain
    )
    params0 = (init_params, optimizer.init(init_params))

    def one_step(carry, rng_key):
        state, params = carry
        state, params, infos = update(rng_key, state, *params)
        return (state, params), infos

    def run(rng_key: jax.Array, positions: jax.Array):
        state0 = init_adapt(mala.init(positions, value_and_score))
        keys = jax.random.split(rng_key, num_steps)
        (last_state, params), infos = jax.lax.scan(
            one_step, (state0, params0), keys
        )
        final_params = parameter_gn(last_state.states, last_state.step, *params)
        return last_state, kernel_factory(*final_params), final_params[0], infos

    return AdaptationAlgorithm(run)
