"""Flow-proposal chain-refresh kernels — the "Markovian" part of MFM.

Three interchangeable ensemble kernels that refresh MCMC chains through the
learned CNF, parity with the reference trio
(/root/reference/exe_flow_matching.py:246-298):

- ``independence_mh``   proposal = push-forward of a fresh reference draw;
                        acceptance uses the flow density on both sides (:246-260)
- ``pullback_rwm``      random-walk MH in pullback space with the optimal
                        scale 2.38 / sqrt(d) (:262-278); the effective target
                        is pi~(u) = pi(T(u)) |det dT/du|
- ``cis_refresh``       conditional importance sampling over N fresh
                        reference draws plus the kept previous pullback (:280-296)

Batched redesign: every kernel runs the **whole ensemble through one ODE
solve** — for CIS the (B, N) candidate grid is flattened to a single
(B*N, d) batch so all candidates ride one transport — and accept/select is a
batched ``where``/gather, never a per-chain ``lax.cond``. Selection by the
sign of ``num_importance_samples`` (reference :298) is provided by
``select_flow_kernel``.

Log-density convention (see mfm_tpu.flows.cnf): transports return
``logdet = log|det dx/du|`` and ``log q(x) = log q0(u) - logdet``.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from mfm_tpu.flows.cnf import Transport
from mfm_tpu.kernels.base import ChainInfo, ChainState


class FlowTarget(NamedTuple):
    """Everything a flow kernel needs to know about target + reference.

    value_and_score : batched (B, d) -> ((B,), (B, d)) of the (tempered)
                      target log-density
    ref_log_prob    : batched (B, d) -> (B,) reference log-density
    ref_sample      : (key, shape) -> shape + (d,) reference sampler
    """

    value_and_score: Callable
    ref_log_prob: Callable
    ref_sample: Callable


def independence_mh(
    key: jax.Array,
    state: ChainState,
    params,
    transport: Transport,
    tgt: FlowTarget,
):
    """Whole-ensemble independence MH through the flow."""
    B = state.position.shape[0]
    key_gen, key_acc, key_h1, key_h2 = jax.random.split(key, 4)

    u_prop = tgt.ref_sample(key_gen, (B,))
    x_prop, logdet_prop = transport.forward(params, u_prop, key_h1)
    u_cur, logdet_cur = transport.inverse(params, state.position, key_h2)

    prop_ld, prop_grad = tgt.value_and_score(x_prop)
    logq_prop = tgt.ref_log_prob(u_prop) - logdet_prop
    logq_cur = tgt.ref_log_prob(u_cur) - logdet_cur
    log_ratio = (prop_ld - logq_prop) - (state.logdensity - logq_cur)
    log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
    p_accept = jnp.exp(jnp.minimum(log_ratio, 0.0))
    accept = jax.random.uniform(key_acc, (B,)) < p_accept

    new_state = ChainState(
        jnp.where(accept[:, None], x_prop, state.position),
        jnp.where(accept, prop_ld, state.logdensity),
        jnp.where(accept[:, None], prop_grad, state.logdensity_grad),
    )
    return new_state, ChainInfo(p_accept, accept, x_prop, jnp.zeros(B))


def pullback_rwm(
    key: jax.Array,
    state: ChainState,
    params,
    transport: Transport,
    tgt: FlowTarget,
):
    """Random-walk MH in pullback space, ensemble-batched.

    Targets pi~(u) = pi(T(u)) |det dT/du|; with a symmetric proposal the
    acceptance is exp((log pi(x') + logdet') - (log pi(x) + logdet)).
    """
    B, d = state.position.shape
    key_gen, key_acc, key_h1, key_h2 = jax.random.split(key, 4)
    scale = 2.38 / jnp.sqrt(d)

    u_cur, logdet_cur = transport.inverse(params, state.position, key_h2)
    u_prop = u_cur + scale * jax.random.normal(key_gen, (B, d), u_cur.dtype)
    x_prop, logdet_prop = transport.forward(params, u_prop, key_h1)

    prop_ld, prop_grad = tgt.value_and_score(x_prop)
    log_ratio = (prop_ld + logdet_prop) - (state.logdensity + logdet_cur)
    log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
    p_accept = jnp.exp(jnp.minimum(log_ratio, 0.0))
    accept = jax.random.uniform(key_acc, (B,)) < p_accept

    new_state = ChainState(
        jnp.where(accept[:, None], x_prop, state.position),
        jnp.where(accept, prop_ld, state.logdensity),
        jnp.where(accept[:, None], prop_grad, state.logdensity_grad),
    )
    return new_state, ChainInfo(p_accept, accept, x_prop, jnp.zeros(B))


def cis_refresh(
    key: jax.Array,
    state: ChainState,
    params,
    transport: Transport,
    tgt: FlowTarget,
    num_samples: int,
):
    """Conditional importance sampling refresh, one flat transport batch.

    Candidate 0 is the previous position (through the inverse map); the N
    fresh candidates are pushed forward as a single (B*N, d) batch.
    """
    B, d = state.position.shape
    key_gen, key_choice, key_h1, key_h2 = jax.random.split(key, 4)

    u_cur, logdet_cur = transport.inverse(params, state.position, key_h2)
    prev_logw = state.logdensity - (tgt.ref_log_prob(u_cur) - logdet_cur)

    u_new = tgt.ref_sample(key_gen, (B * num_samples,))
    x_new, logdet_new = transport.forward(params, u_new, key_h1)
    new_ld = tgt.value_and_score(x_new)[0]
    logw = new_ld - (tgt.ref_log_prob(u_new) - logdet_new)

    all_logw = jnp.concatenate(
        [prev_logw[:, None], logw.reshape(B, num_samples)], axis=1
    )  # (B, N+1)
    all_logw = jnp.where(jnp.isnan(all_logw), -jnp.inf, all_logw)
    choice = jax.random.categorical(key_choice, all_logw, axis=1)  # (B,)

    cand_pos = jnp.concatenate(
        [state.position[:, None, :], x_new.reshape(B, num_samples, d)], axis=1
    )
    cand_ld = jnp.concatenate(
        [state.logdensity[:, None], new_ld.reshape(B, num_samples)], axis=1
    )
    sel_pos = jnp.take_along_axis(cand_pos, choice[:, None, None], axis=1)[:, 0]
    sel_ld = jnp.take_along_axis(cand_ld, choice[:, None], axis=1)[:, 0]
    # one batched score pass on the selected positions only (the reference
    # carries a stale gradient here, exe_flow_matching.py:295; we recompute)
    sel_grad = tgt.value_and_score(sel_pos)[1]

    norm_w = jax.nn.softmax(all_logw, axis=1)
    sel_w = jnp.take_along_axis(norm_w, choice[:, None], axis=1)[:, 0]
    new_state = ChainState(sel_pos, sel_ld, sel_grad)
    return new_state, ChainInfo(sel_w, choice != 0, sel_pos, sel_w)


def select_flow_kernel(num_importance_samples: int) -> Callable:
    """Reference dispatch rule (exe_flow_matching.py:298): positive -> CIS,
    negative -> independence MH, zero -> pullback RWM (default)."""
    if num_importance_samples > 0:
        def kernel(key, state, params, transport, tgt):
            return cis_refresh(
                key, state, params, transport, tgt, num_importance_samples
            )

        return kernel
    if num_importance_samples < 0:
        return independence_mh
    return pullback_rwm
