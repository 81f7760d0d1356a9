"""Stan-style window adaptation (dual-averaging step size + diagonal mass),
ensemble-batched.

Part of the BASELINE north star ("window adaptation" for the MCMC layer);
absent from the vendored reference fork. Ensemble twist: statistics pool
across the whole chain ensemble — the dual-averaging update consumes the
*mean* acceptance of all B chains per step, and the mass matrix is a Welford
estimate over (iters x chains) positions — so adaptation signal scales with
the ensemble instead of a single chain.

Phases (Stan windows): fast(75) | slow doubling (25, 50, 100, ...) | fast(50)
with step-size-only adaptation in fast windows and mass+step in slow ones;
the step size re-anchors at each slow-window boundary.
"""

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from mfm_tpu.kernels.base import AdaptationAlgorithm


class DualAveragingState(NamedTuple):
    log_step: jax.Array
    log_step_avg: jax.Array
    grad_avg: jax.Array
    count: jax.Array
    mu: jax.Array


def da_init(step_size: float) -> DualAveragingState:
    # default float dtype (not hardcoded f32): under jax_enable_x64 the
    # other carry leaves (zeros below) are f64, and da_update's promotion
    # would otherwise change the carry dtype mid-scan
    step = jnp.asarray(step_size, jnp.result_type(float))
    return DualAveragingState(
        jnp.log(step),
        jnp.log(step),
        jnp.zeros(()),
        jnp.zeros(()),
        jnp.log(10.0 * step),
    )


def da_update(
    state: DualAveragingState,
    accept_prob: jax.Array,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    count = state.count + 1.0
    w = 1.0 / (count + t0)
    grad_avg = (1.0 - w) * state.grad_avg + w * (target - accept_prob)
    log_step = state.mu - jnp.sqrt(count) / gamma * grad_avg
    eta = count**-kappa
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, grad_avg, count, state.mu)


class WelfordState(NamedTuple):
    mean: jax.Array  # (d,)
    m2: jax.Array  # (d,)
    count: jax.Array


def welford_init(dim: int) -> WelfordState:
    return WelfordState(jnp.zeros(dim), jnp.zeros(dim), jnp.zeros(()))


def welford_update_batch(state: WelfordState, batch: jax.Array) -> WelfordState:
    """Merge a (B, d) batch into the running estimate (Chan et al. merge)."""
    b = batch.shape[0]
    bmean = jnp.mean(batch, axis=0)
    bm2 = jnp.sum((batch - bmean) ** 2, axis=0)
    delta = bmean - state.mean
    total = state.count + b
    mean = state.mean + delta * (b / jnp.maximum(total, 1.0))
    m2 = state.m2 + bm2 + delta**2 * state.count * b / jnp.maximum(total, 1.0)
    return WelfordState(mean, m2, total)


def welford_variance(state: WelfordState, regularize: bool = True) -> jax.Array:
    var = state.m2 / jnp.maximum(state.count - 1.0, 1.0)
    if regularize:  # Stan's shrinkage toward unit scale
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def build_schedule(num_steps: int, init_buffer=75, term_buffer=50, first_window=25):
    """(is_slow, is_window_end) boolean arrays of length num_steps."""
    import numpy as np

    is_slow = np.zeros(num_steps, bool)
    is_end = np.zeros(num_steps, bool)
    if num_steps < 20:
        return jnp.asarray(is_slow), jnp.asarray(is_end)
    if init_buffer + first_window + term_buffer > num_steps:
        init_buffer = max(num_steps // 4, 1)
        term_buffer = max(num_steps // 4, 1)
        first_window = num_steps - init_buffer - term_buffer
    pos = init_buffer
    window = first_window
    while pos < num_steps - term_buffer:
        end = min(pos + window, num_steps - term_buffer)
        # final window absorbs a too-small remainder
        if num_steps - term_buffer - end < window * 2 and end != num_steps - term_buffer:
            end = num_steps - term_buffer
        is_slow[pos:end] = True
        is_end[end - 1] = True
        pos = end
        window *= 2
    return jnp.asarray(is_slow), jnp.asarray(is_end)


def window_adaptation(
    kernel: Callable,
    init_fn: Callable,
    num_steps: int,
    initial_step_size: float = 0.1,
    target_acceptance: float = 0.8,
    adapt_mass: bool = True,
) -> AdaptationAlgorithm:
    """Adapt (step_size, diagonal inverse mass) for an ensemble kernel.

    kernel(key, chain_state, step_size, inverse_mass) -> (state, info) with
    info.acceptance_rate of shape (B,); init_fn(positions) -> chain state.
    Returns run(key, positions) -> (last_state, (step_size, inverse_mass)).
    """
    is_slow, is_end = build_schedule(num_steps)

    def run(rng_key: jax.Array, positions: jax.Array):
        dim = positions.shape[-1]
        state0 = init_fn(positions)
        carry0 = (
            state0,
            da_init(initial_step_size),
            welford_init(dim),
            jnp.ones(dim),  # inverse mass
        )

        def body(carry, xs):
            key, slow, end = xs
            state, da, wf, inv_mass = carry
            step_size = jnp.exp(da.log_step)
            state, info = kernel(key, state, step_size, inv_mass)
            da = da_update(da, jnp.mean(info.acceptance_rate), target_acceptance)

            if adapt_mass:
                wf_new = welford_update_batch(wf, state.position)
                wf = jax.tree_util.tree_map(
                    lambda new, old: jnp.where(slow, new, old), wf_new, wf
                )
                new_inv_mass = welford_variance(wf)
                inv_mass = jnp.where(end, new_inv_mass, inv_mass)
                # at a window boundary: reset Welford, re-anchor dual averaging
                wf = jax.tree_util.tree_map(
                    lambda cur, fresh: jnp.where(end, fresh, cur),
                    wf,
                    welford_init(dim),
                )
                da_fresh = da_init(jnp.exp(da.log_step_avg))
                da = jax.tree_util.tree_map(
                    lambda cur, fresh: jnp.where(end, fresh, cur), da, da_fresh
                )
            return (state, da, wf, inv_mass), jnp.mean(info.acceptance_rate)

        keys = jax.random.split(rng_key, num_steps)
        (state, da, _, inv_mass), acc = lax.scan(
            body, carry0, (keys, is_slow, is_end)
        )
        return state, (jnp.exp(da.log_step_avg), inv_mass), acc

    return AdaptationAlgorithm(run)
