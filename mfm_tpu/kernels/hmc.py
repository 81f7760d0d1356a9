"""Hamiltonian Monte Carlo, ensemble-batched.

The BASELINE north star asks for the MCMC layer to include HMC alongside
MALA (the reference's upstream blackjax has it; the vendored fork dropped
it). This is a batched ensemble implementation: one (B, d) leapfrog
trajectory for the whole chain block — each step is a batched score pass —
with diagonal (or scalar) inverse mass, batched Metropolis acceptance, and
energy-divergence flagging.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from mfm_tpu.kernels.base import ChainState, SamplingAlgorithm
from mfm_tpu.kernels.mala import init  # same cached-state initializer
from mfm_tpu.kernels.proposal import (
    Proposal,
    proposal_from_energy_diff,
    static_binomial_sampling,
)


class HMCInfo(NamedTuple):
    acceptance_rate: jax.Array  # (B,)
    is_accepted: jax.Array  # (B,)
    is_divergent: jax.Array  # (B,)
    energy: jax.Array  # (B,) proposal Hamiltonian
    proposed_position: jax.Array  # (B, d)
    num_integration_steps: int


def _leapfrog(value_and_score, position, momentum, grad, step_size, inv_mass, n_steps):
    """Velocity-Verlet for the whole ensemble; returns final (q, p, logdens, grad)."""

    def body(carry, _):
        q, p, g = carry
        p = p + 0.5 * step_size * g
        q = q + step_size * (inv_mass * p)
        logdens, g = value_and_score(q)
        p = p + 0.5 * step_size * g
        return (q, p, g), logdens

    (q, p, g), logdens = lax.scan(
        body, (position, momentum, grad), None, length=n_steps
    )
    return q, p, logdens[-1], g


def build_kernel(
    value_and_score: Callable,
    divergence_threshold: float = 1000.0,
) -> Callable:
    """kernel(key, state, step_size, num_integration_steps, inverse_mass)
    where inverse_mass is a scalar, (d,) diagonal, or None for identity."""

    def kernel(
        rng_key: jax.Array,
        state: ChainState,
        step_size: float,
        num_integration_steps: int,
        inverse_mass: Optional[jax.Array] = None,
    ) -> Tuple[ChainState, HMCInfo]:
        B, d = state.position.shape
        inv_mass = jnp.ones(d) if inverse_mass is None else jnp.asarray(inverse_mass)
        key_mom, key_acc = jax.random.split(rng_key)

        # momentum ~ N(0, M): sample via M^{1/2} eps with M = 1 / inv_mass
        eps = jax.random.normal(key_mom, (B, d), state.position.dtype)
        momentum = eps / jnp.sqrt(inv_mass)

        q, p, prop_logdens, prop_grad = _leapfrog(
            value_and_score,
            state.position,
            momentum,
            state.logdensity_grad,
            step_size,
            inv_mass,
            num_integration_steps,
        )

        kinetic0 = 0.5 * jnp.sum(momentum * momentum * inv_mass, axis=-1)
        kinetic1 = 0.5 * jnp.sum(p * p * inv_mass, axis=-1)
        h0 = -state.logdensity + kinetic0
        h1 = -prop_logdens + kinetic1

        # Metropolis accept via the shared proposal algebra (energy drop
        # h0 - h1, NaN -> reject, divergence flagging included)
        proposed_state = ChainState(q, prop_logdens, prop_grad)
        new_proposal, divergent = proposal_from_energy_diff(
            h0, h1, divergence_threshold, proposed_state
        )
        prev = Proposal(state, h0, jnp.zeros_like(h0), jnp.zeros_like(h0))
        sampled, accept, p_accept = static_binomial_sampling(
            key_acc, prev, new_proposal
        )
        new_state = sampled.state
        info = HMCInfo(p_accept, accept, divergent, h1, q, num_integration_steps)
        return new_state, info

    return kernel


def hmc(
    value_and_score: Callable,
    step_size: float,
    num_integration_steps: int = 10,
    inverse_mass: Optional[jax.Array] = None,
) -> SamplingAlgorithm:
    kernel = build_kernel(value_and_score)

    def init_fn(position):
        return init(position, value_and_score)

    def step_fn(rng_key, state):
        return kernel(rng_key, state, step_size, num_integration_steps, inverse_mass)

    return SamplingAlgorithm(init_fn, step_fn)
