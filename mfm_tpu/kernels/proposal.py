"""Proposal algebra: reusable accept/reject combinators for building MH-type
kernels.

Capability parity with /root/reference/bblackjax/mcmc/proposal.py —
symmetric and asymmetric energy-difference proposals, static binomial
accept/reject, progressive uniform/biased sampling for trajectory-building
samplers, and non-reversible slice acceptance — redesigned **vectorized**:
every combinator acts on a (B,)-leading ensemble of proposals and resolves
accept/reject with ``jnp.where`` masks (no per-chain ``lax.cond``), so
kernels composed from these pieces stay single fused programs.

Production consumers: ``kernels.mala`` and ``kernels.hmc`` build their MH
accept/reject from ``proposal_from_energy_diff`` + ``static_binomial_sampling``
(one acceptance implementation, not two). ``kernels.nuts`` intentionally does
NOT consume the progressive samplers: its tree merges are the same math but
carry per-chain activity masks (``grow``/``valid``) threaded through the
doubling loop, which the mask-free ``Proposal`` combinators cannot express
without packing/unpacking at every merge; the correspondence is pinned by
the NUTS-vs-oracle tests instead.
"""

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Proposal(NamedTuple):
    """Ensemble of proposals.

    state            pytree with (B,)-leading leaves
    energy           (B,) total energy of each proposal
    weight           (B,) log-weight vs the originating state
    sum_log_p_accept (B,) accumulated log acceptance probability
    """

    state: NamedTuple
    energy: jax.Array
    weight: jax.Array
    sum_log_p_accept: jax.Array


def _select(accept, new: Proposal, old: Proposal) -> Proposal:
    """Batched proposal selection by a (B,) boolean mask."""

    def pick(n, o):
        mask = accept.reshape(accept.shape + (1,) * (n.ndim - accept.ndim))
        return jnp.where(mask, n, o)

    state = jax.tree_util.tree_map(pick, new.state, old.state)
    return Proposal(
        state,
        jnp.where(accept, new.energy, old.energy),
        new.weight,  # bookkeeping fields always reflect the latest proposal
        new.sum_log_p_accept,
    )


def proposal_from_energy_diff(
    prev_energy, new_energy, divergence_threshold: float, state
) -> Tuple[Proposal, jax.Array]:
    """Weight a proposal by the energy drop; flag divergent transitions
    (reference proposal.py:80-125), batched."""
    delta = prev_energy - new_energy
    delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
    is_divergent = jnp.abs(delta) > divergence_threshold
    return (
        Proposal(state, new_energy, delta, jnp.minimum(delta, 0.0)),
        is_divergent,
    )


def proposal_generator(energy_fn: Callable, divergence_threshold: float):
    """Symmetric-proposal pair (new, update) (reference proposal.py:30-77)."""

    def new(state) -> Proposal:
        e = energy_fn(state)
        return Proposal(state, e, jnp.zeros_like(e), jnp.full_like(e, -jnp.inf))

    def update(initial_energy, state) -> Tuple[Proposal, jax.Array]:
        return proposal_from_energy_diff(
            initial_energy, energy_fn(state), divergence_threshold, state
        )

    return new, update


def asymmetric_proposal_generator(
    transition_energy_fn: Callable, divergence_threshold: float
):
    """Asymmetric-proposal pair using forward/backward transition energies
    (reference proposal.py:125-161). ``transition_energy_fn(a, b)`` is the
    energy of moving a -> b; acceptance uses E(a->b) - E(b->a)."""

    def new(state) -> Proposal:
        zeros = jnp.zeros(jax.tree_util.tree_leaves(state)[0].shape[:1])
        return Proposal(state, zeros, zeros, jnp.full_like(zeros, -jnp.inf))

    def update(initial_state, state, **energy_params) -> Tuple[Proposal, jax.Array]:
        fwd = transition_energy_fn(initial_state, state, **energy_params)
        bwd = transition_energy_fn(state, initial_state, **energy_params)
        # accept with exp(fwd - bwd): see mfm_tpu.kernels.mala for the sign
        # derivation and the invariance test pinning it down
        return proposal_from_energy_diff(fwd, bwd, divergence_threshold, state)

    return new, update


def static_binomial_sampling(rng_key, proposal: Proposal, new_proposal: Proposal):
    """Vanilla MH accept/reject for the whole ensemble
    (reference proposal.py:169-186)."""
    p_accept = jnp.clip(jnp.exp(new_proposal.weight), max=1.0)
    accept = jax.random.bernoulli(rng_key, p_accept)
    return _select(accept, new_proposal, proposal), accept, p_accept


def progressive_uniform_sampling(rng_key, proposal: Proposal, new_proposal: Proposal):
    """Multinomial-among-trajectory sampling: keep the new proposal with
    probability w_new / (w_old + w_new) (reference proposal.py:199-227)."""
    p_accept = jax.scipy.special.expit(new_proposal.weight - proposal.weight)
    accept = jax.random.bernoulli(rng_key, p_accept)
    weight = jnp.logaddexp(proposal.weight, new_proposal.weight)
    slp = jnp.logaddexp(proposal.sum_log_p_accept, new_proposal.sum_log_p_accept)
    out = _select(accept, new_proposal, proposal)
    return Proposal(out.state, out.energy, weight, slp)


def progressive_biased_sampling(rng_key, proposal: Proposal, new_proposal: Proposal):
    """Biased progressive sampling favoring the new subtree
    (Betancourt 2017; reference proposal.py:230-255)."""
    p_accept = jnp.clip(jnp.exp(new_proposal.weight - proposal.weight), max=1.0)
    accept = jax.random.bernoulli(rng_key, p_accept)
    weight = jnp.logaddexp(proposal.weight, new_proposal.weight)
    slp = jnp.logaddexp(proposal.sum_log_p_accept, new_proposal.sum_log_p_accept)
    out = _select(accept, new_proposal, proposal)
    return Proposal(out.state, out.energy, weight, slp)


def nonreversible_slice_sampling(slice_var, proposal: Proposal, new_proposal: Proposal):
    """Neal 2020 non-reversible accept/reject driven by a persistent
    uniform slice variable (reference proposal.py:263-277), batched."""
    delta = new_proposal.weight
    accept = jnp.log(jnp.abs(slice_var)) <= delta
    out = _select(accept, new_proposal, proposal)
    new_slice = jnp.where(accept, slice_var * jnp.exp(-delta), slice_var)
    return out, accept, new_slice
