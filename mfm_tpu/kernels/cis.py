"""Conditional importance sampling kernel (standalone library form).

Parity with the reference CIS kernel (/root/reference/bblackjax/mcmc/cis.py):
keep the previous pullback point, draw ``num_samples`` fresh standard-normal
reference points, push **all** candidates through the flow, and pick per
chain from the importance weights

    w = exp(log pi(x) + logdet + ||u||^2 / 2)   (cis.py:42-53)

i.e. w = pi(x) / q_flow(x) for a standard-normal reference.

Batched redesign: the (B, N+1) candidate grid flattens into one
(B*(N+1), d) flow batch — a single transport pass for the whole ensemble —
and selection is a batched log-space categorical + gather. (The driver-level
variant in mfm_tpu.flows.flow_mh additionally re-uses cached target values;
this standalone kernel works with any flow callable.)
"""

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mfm_tpu.kernels.base import SamplingAlgorithm


class CISState(NamedTuple):
    position: jax.Array  # (B, d)
    pullback_position: jax.Array  # (B, d)


class CISInfo(NamedTuple):
    positions: jax.Array  # (B, N+1, d) all candidates
    pullback_positions: jax.Array  # (B, N+1, d)
    log_weights: jax.Array  # (B, N+1)


def init(pullback_position: jax.Array) -> CISState:
    return CISState(pullback_position, pullback_position)


def build_kernel(num_samples: int) -> Callable:
    """kernel(key, state, logprob_fn, flow) with batched
    logprob_fn: (M, d) -> (M,) and flow: (M, d) -> ((M, d), (M,))."""

    def kernel(
        rng_key: jax.Array,
        state: CISState,
        logprob_fn: Callable,
        flow: Callable,
    ) -> Tuple[CISState, CISInfo]:
        B, d = state.pullback_position.shape
        key_gen, key_pick = jax.random.split(rng_key)

        fresh = jax.random.normal(key_gen, (B, num_samples, d))
        pullbacks = jnp.concatenate(
            [state.pullback_position[:, None, :], fresh], axis=1
        )  # (B, N+1, d)

        flat = pullbacks.reshape(B * (num_samples + 1), d)
        xs, logdets = flow(flat)
        log_w = (
            logprob_fn(xs)
            + logdets
            + 0.5 * jnp.sum(flat * flat, axis=-1)
        ).reshape(B, num_samples + 1)
        log_w = jnp.where(jnp.isnan(log_w), -jnp.inf, log_w)

        choice = jax.random.categorical(key_pick, log_w, axis=1)  # (B,)
        positions = xs.reshape(B, num_samples + 1, d)
        sel = lambda c: jnp.take_along_axis(c, choice[:, None, None], axis=1)[:, 0]
        new_state = CISState(sel(positions), sel(pullbacks))
        return new_state, CISInfo(positions, pullbacks, log_w)

    return kernel


def cis(
    logprob_fn: Callable, flow: Callable, num_importance_samples: int = 1
) -> SamplingAlgorithm:
    kernel = build_kernel(num_importance_samples)

    def init_fn(pullback_position):
        return init(pullback_position)

    def step_fn(rng_key, state):
        return kernel(rng_key, state, logprob_fn, flow)

    return SamplingAlgorithm(init_fn, step_fn)
