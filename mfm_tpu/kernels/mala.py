"""Metropolis-Adjusted Langevin Algorithm, batched over the chain ensemble.

Behavioral parity with the reference MALA kernel
(/root/reference/bblackjax/mcmc/mala.py, diffusions.py, proposal.py):

- Euler-Maruyama Langevin proposal x' = x + h * grad + sqrt(2h) * eps
  (diffusions.py:22-33)
- asymmetric MH correction with transition energy
  E(a -> b) = -log pi(a) + ||b - a - h * grad(a)||^2 / (4h)  (mala.py:68-79)
- acceptance min(1, exp(E(b -> a)... )) via the energy difference, plus the
  fork's extra proposed-position / proposed-weight info (mala.py:104-113)

Batched redesign: the whole ensemble steps at once. One batched
``value_and_score`` of the target per iteration (a (B, d) matmul-heavy pass
for LGCP/phi-four), batched noise, batched row-reductions for the energies,
and a single ``jnp.where`` accept/select — no ``lax.cond`` per chain, no
per-chain key loop on the host.
"""

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from mfm_tpu.kernels.base import ChainInfo, ChainState, SamplingAlgorithm
from mfm_tpu.kernels.proposal import (
    Proposal,
    proposal_from_energy_diff,
    static_binomial_sampling,
)


def init(position: jax.Array, value_and_score: Callable) -> ChainState:
    """Initialize the ensemble state from (n_chain, dim) positions.

    ``value_and_score`` maps (B, d) -> ((B,), (B, d)).
    """
    logdensity, grad = value_and_score(position)
    return ChainState(position, logdensity, grad)


def _transition_energy(logdensity_a, pos_a, grad_a, pos_b, step_size):
    """E(a -> b): batched (mala.py:68-79); rows are chains."""
    theta = pos_b - pos_a - step_size * grad_a
    theta_dot = jnp.sum(theta * theta, axis=-1)
    return -logdensity_a + 0.25 / step_size * theta_dot


def build_kernel(value_and_score: Callable) -> Callable:
    """Build a batched MALA kernel closed over the target's value-and-grad.

    Unlike the reference (which re-derives ``jax.value_and_grad`` from a
    scalar logdensity each call, mala.py:90), the batched oracle is supplied
    directly so targets can fuse the batch (e.g. LGCP's triangular solves).
    """

    def kernel(
        rng_key: jax.Array, state: ChainState, step_size: float
    ) -> Tuple[ChainState, ChainInfo]:
        key_noise, key_accept = jax.random.split(rng_key)

        # Langevin proposal for every chain at once
        noise = jax.random.normal(key_noise, state.position.shape, state.position.dtype)
        proposed = (
            state.position
            + step_size * state.logdensity_grad
            + jnp.sqrt(2.0 * step_size) * noise
        )
        prop_logdensity, prop_grad = value_and_score(proposed)

        # asymmetric MH via the shared proposal algebra. With
        # E(a -> b) = -log pi(a) - log q(b | a) + const, the acceptance
        # ratio pi(x')q(x|x') / (pi(x)q(x'|x)) is
        # exp(E(cur -> prop) - E(prop -> cur)); invariance verified in
        # tests/test_mala.py::test_gaussian_invariance.
        fwd = _transition_energy(
            state.logdensity, state.position, state.logdensity_grad, proposed, step_size
        )
        bwd = _transition_energy(
            prop_logdensity, proposed, prop_grad, state.position, step_size
        )
        proposed_state = ChainState(proposed, prop_logdensity, prop_grad)
        new_proposal, _ = proposal_from_energy_diff(
            fwd, bwd, jnp.inf, proposed_state
        )
        prev = Proposal(state, fwd, jnp.zeros_like(fwd), jnp.zeros_like(fwd))
        sampled, accept, p_accept = static_binomial_sampling(
            key_accept, prev, new_proposal
        )
        new_state = sampled.state
        # fork extension: unnormalized importance weight of the proposal
        # (mala.py:104-113): exp(log pi(x') + ||x - x' - h grad(x')||^2 / 4h)
        theta = state.position - proposed - step_size * prop_grad
        proposed_weight = jnp.exp(
            prop_logdensity + 0.25 / step_size * jnp.sum(theta * theta, axis=-1)
        )
        info = ChainInfo(p_accept, accept, proposed, proposed_weight)
        return new_state, info

    return kernel


def mala(value_and_score: Callable, step_size: float) -> SamplingAlgorithm:
    """User-facing constructor mirroring the reference ``mala`` class
    (mala.py:121-188), ensemble-batched."""
    kernel = build_kernel(value_and_score)

    def init_fn(position):
        return init(position, value_and_score)

    def step_fn(rng_key, state):
        return kernel(rng_key, state, step_size)

    return SamplingAlgorithm(init_fn, step_fn)


@partial(jax.jit, static_argnames=("kernel", "n_steps"))
def run_chain(rng_key, kernel, state, step_size, n_steps: int):
    """Scan-driven ensemble runner (reference mcmc_utils.py:11-25), on-device."""
    keys = jax.random.split(rng_key, n_steps)

    def step(carry, key):
        new_state, info = kernel(key, carry, step_size)
        return new_state, (new_state.position, info.acceptance_rate)

    final, (positions, acc) = jax.lax.scan(step, state, keys)
    return final, positions, acc
