"""Kernel protocol and shared state containers.

Batched counterpart of the reference ``SamplingAlgorithm`` protocol
(/root/reference/bblackjax/base.py:76-103). The decisive difference: kernels
here are **ensemble kernels** — ``init`` and ``step`` act on an entire
``(n_chain, dim)`` batch at once, so every inner op is a large batched
matmul / elementwise pass that XLA compiles as a whole. Per-chain
functions lifted with ``jax.vmap`` (the reference pattern,
exe_flow_matching.py:303-314) are the slow path, not the design center.
"""

from typing import Callable, NamedTuple

import jax


class ChainState(NamedTuple):
    """State of a gradient-informed chain ensemble.

    All leaves carry a leading ``(n_chain,)`` axis. Caching log-density and
    its gradient avoids recomputation across steps (same motivation as the
    reference MALAState, bblackjax/mcmc/mala.py:16-28).
    """

    position: jax.Array  # (n_chain, dim)
    logdensity: jax.Array  # (n_chain,)
    logdensity_grad: jax.Array  # (n_chain, dim)


class ChainInfo(NamedTuple):
    """Per-transition diagnostics (reference MALAInfo, mala.py:31-48, with the
    fork's extra proposed-position/weight fields)."""

    acceptance_rate: jax.Array  # (n_chain,)
    is_accepted: jax.Array  # (n_chain,) bool
    proposed_position: jax.Array  # (n_chain, dim)
    proposed_weight: jax.Array  # (n_chain,)


class SamplingAlgorithm(NamedTuple):
    """A pair of pure functions (init, step) defining an ensemble sampler."""

    init: Callable
    step: Callable


class AdaptationAlgorithm(NamedTuple):
    """A warmup/adaptation procedure exposing a single ``run``."""

    run: Callable


def inference_loop(rng_key, step_fn: Callable, initial_state, n_steps: int):
    """Scan-driven runner for any ensemble sampler (counterpart of the
    reference inference_loop, mcmc_utils.py:11-25): returns the per-step
    states and infos stacked on a leading time axis."""
    import jax
    from jax import lax

    keys = jax.random.split(rng_key, n_steps)

    def body(state, key):
        state, info = step_fn(key, state)
        return state, (state, info)

    _, (states, infos) = lax.scan(body, initial_state, keys)
    return states, infos
