"""Generic SMC step: resample -> move -> reweigh.

Parity with /root/reference/bblackjax/smc/base.py:55-134, including the
waste-free hook (``num_resampled`` < N with an update function returning N
particles) and the log-normalizing-constant increment. The update function
here is an **ensemble move**: it receives one key and the whole (N, d)
particle block (batched; the reference takes pre-split per-particle keys
and a vmapped kernel).
"""

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class SMCState(NamedTuple):
    particles: jax.Array  # (N, d)
    weights: jax.Array  # (N,), normalized


class SMCInfo(NamedTuple):
    ancestors: jax.Array  # (num_resampled,): (N,) standard, (M,) waste-free
    log_likelihood_increment: jax.Array  # scalar
    update_info: NamedTuple


def init(particles: jax.Array) -> SMCState:
    n = particles.shape[0]
    return SMCState(particles, jnp.full((n,), 1.0 / n, particles.dtype))


def step(
    rng_key: jax.Array,
    state: SMCState,
    update_fn: Callable,
    weigh_fn: Callable,
    resample_fn: Callable,
    num_resampled: Optional[int] = None,
    gather_fn: Optional[Callable] = None,
):
    """One Feynman-Kac step.

    update_fn(key, particles) -> (new_particles, info)   [ensemble move M_t]
    weigh_fn(particles)       -> (N,) log-weights        [potential G_t]
    resample_fn(key, weights, n) -> ancestor indices
    gather_fn(particles, ancestors) -> resampled particles; defaults to
        ``jnp.take``. Under a sharded mesh pass
        ``smc.distributed.make_distributed_gather`` so the post-resample
        exchange runs as a ppermute ring instead of an XLA all-gather of
        the particle matrix.
    """
    key_update, key_resample = jax.random.split(rng_key)
    n = state.weights.shape[0]
    if num_resampled is None:
        num_resampled = n

    ancestors = resample_fn(key_resample, state.weights, num_resampled)
    if gather_fn is None:
        particles = jnp.take(state.particles, ancestors, axis=0)
    else:
        particles = gather_fn(state.particles, ancestors)
    particles, update_info = update_fn(key_update, particles)

    log_weights = weigh_fn(particles)
    log_sum = jax.scipy.special.logsumexp(log_weights)
    log_z_increment = log_sum - jnp.log(n)
    weights = jnp.exp(log_weights - log_sum)

    return SMCState(particles, weights), SMCInfo(ancestors, log_z_increment, update_info)
