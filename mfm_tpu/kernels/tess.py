"""Transport elliptical slice sampler (TESS), ensemble-batched.

Parity with the reference TESS kernel
(/root/reference/bblackjax/mcmc/tess.py): slice sampling on an ellipse in
the pullback space of a transport map T, with bracket-shrinkage search. The
slice function is ``log pi(T(u)) + logdet T(u) - ||m||^2 / 2`` (tess.py:42-44,
with logdet in this repo's +log|det dT/du| convention).

Batched redesign: the reference shrinks the bracket per chain in a scalar
``while_loop`` under vmap (tess.py:109-124). Here one **masked batched
while_loop** drives the whole ensemble: every iteration evaluates the flow
once for all B chains (one batched ODE solve / transport GEMM pass) and
chains that already accepted keep their state via ``where`` masks. The loop
runs until the slowest chain accepts — the same wall-clock as vmap's
implicit masking, but each trip is ensemble-wide fused compute.
"""

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from mfm_tpu.kernels.base import SamplingAlgorithm


class TESSState(NamedTuple):
    position: jax.Array  # (B, d) in data space
    pullback_position: jax.Array  # (B, d) in reference space


class TESSInfo(NamedTuple):
    momentum: jax.Array  # (B, d)
    slice_value: jax.Array  # (B,)
    theta: jax.Array  # (B,)
    subiter: jax.Array  # (B,) shrinkage steps used per chain


def init(pullback_position: jax.Array) -> TESSState:
    return TESSState(pullback_position, pullback_position)


def _ellipse(u0, m0, theta):
    """Rotate (u0, m0) by per-chain angles theta on their joint ellipse."""
    c = jnp.cos(theta)[:, None]
    s = jnp.sin(theta)[:, None]
    return u0 * c + m0 * s, m0 * c - u0 * s


def build_kernel(max_subiter: int = 100) -> Callable:
    """Build the batched TESS kernel.

    kernel(key, state, logprob_fn, flow) where
      logprob_fn : (B, d) -> (B,) target log-density
      flow       : (B, d) -> ((B, d), (B,)) transport + log|det|
    """

    def kernel(
        rng_key: jax.Array,
        state: TESSState,
        logprob_fn: Callable,
        flow: Callable,
    ) -> Tuple[TESSState, TESSInfo]:
        u0 = state.pullback_position
        B = u0.shape[0]
        key_mom, key_y, key_theta, key_loop = jax.random.split(rng_key, 4)

        def slice_fn(u, m):
            x, logdet = flow(u)
            return logprob_fn(x) + logdet - 0.5 * jnp.sum(m * m, axis=-1)

        momentum = jax.random.normal(key_mom, u0.shape, u0.dtype)
        log_y = slice_fn(u0, momentum) + jnp.log(
            jax.random.uniform(key_y, (B,))
        )

        theta = 2.0 * jnp.pi * jax.random.uniform(key_theta, (B,))
        theta_min = theta - 2.0 * jnp.pi
        theta_max = theta
        u, m = _ellipse(u0, momentum, theta)
        s = slice_fn(u, m)

        def cond(carry):
            it, key, s, subiter, theta, tmin, tmax, u, m, active = carry
            return jnp.any(active) & (it < max_subiter)

        def body(carry):
            it, key, s, subiter, theta, tmin, tmax, u, m, active = carry
            key, sub = jax.random.split(key)
            prop_theta = jax.random.uniform(sub, (B,), minval=tmin, maxval=tmax)
            theta_new = jnp.where(active, prop_theta, theta)
            u_new, m_new = _ellipse(u0, momentum, theta_new)
            s_new = slice_fn(u_new, m_new)
            # masked updates: finished chains keep their accepted state
            u = jnp.where(active[:, None], u_new, u)
            m = jnp.where(active[:, None], m_new, m)
            s = jnp.where(active, s_new, s)
            theta = theta_new
            tmin = jnp.where(active & (theta < 0), theta, tmin)
            tmax = jnp.where(active & (theta > 0), theta, tmax)
            subiter = subiter + active.astype(jnp.int32)
            still = active & ((s <= log_y) | ~jnp.isfinite(s))
            return (it + 1, key, s, subiter, theta, tmin, tmax, u, m, still)

        active0 = (s <= log_y) | ~jnp.isfinite(s)
        carry = (
            0,
            key_loop,
            s,
            jnp.ones(B, jnp.int32),
            theta,
            theta_min,
            theta_max,
            u,
            m,
            active0,
        )
        _, _, s, subiter, theta, _, _, u, m, _ = lax.while_loop(cond, body, carry)

        position = flow(u)[0]
        return TESSState(position, u), TESSInfo(m, s, theta, subiter)

    return kernel


def tess(logprob_fn: Callable, flow: Callable) -> SamplingAlgorithm:
    """User-facing constructor (parity with the reference ``tess`` class)."""
    kernel = build_kernel()

    def init_fn(pullback_position):
        return init(pullback_position)

    def step_fn(rng_key, state):
        return kernel(rng_key, state, logprob_fn, flow)

    return SamplingAlgorithm(init_fn, step_fn)
