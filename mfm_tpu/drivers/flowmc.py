"""In-repo flowMC: normalizing-flow enhanced MCMC.

The reference runs this baseline through the external ``flowMC`` package
(/root/reference/exe_others.py:114-199: MaskedCouplingRQSpline flow + MALA
local sampler + flow-proposal global moves, then post-hoc IS reweighting of
flow samples :194-199). That package is absent here, so this module
implements the algorithm itself (Gabrié, Rotskoff & Vanden-Eijnden, PNAS
2022; Wong, Gabrié & Foreman-Mackey, JOSS 2023) from in-repo parts:

- the spline coupling flow (flows/coupling.py — the same flow family as
  MaskedCouplingRQSpline, exact two-way densities);
- the ensemble-batched MALA kernel (kernels/mala.py) as the local sampler;
- independence-MH global moves through the flow: propose y ~ q_theta,
  accept w.p. min(1, pi(y) q(x) / (pi(x) q(y))) — the same acceptance rule
  as the CNF path's flows/flow_mh.py::indep_mh, restated here for the
  discrete flow's exact densities;
- max-likelihood flow training (NLL on chain history) with adam.

On-device: the reference package runs a Python loop per training round
with host transfers between local sampling / training / global sampling;
here ONE ``lax.scan`` carries (chain states, flow params, opt state, ring
buffer of positions) through n_loop rounds, each round = scanned local
steps -> scanned train epochs on minibatches from the buffer -> scanned
global steps. Zero host round-trips until the final metrics fetch.
"""

import time
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from mfm_tpu.flows.coupling import make_coupling_flow
from mfm_tpu.kernels import mala
from mfm_tpu.targets.base import Target
from mfm_tpu.utils.pytree import host_chunked_scan


class FlowMCCarry(NamedTuple):
    states: Any  # ensemble MALAState
    params: Any  # flow params
    opt_state: Any
    buf: jax.Array  # (cap, d) chain-position history
    buf_len: jax.Array  # filled prefix length
    buf_ptr: jax.Array  # ring write pointer


class FlowMCResult(NamedTuple):
    params: Any
    flow: Any  # CouplingFlow handle
    positions: jax.Array  # (n_loop, n_chain, d) end-of-round positions
    local_accept: jax.Array  # (n_loop,)
    global_accept: jax.Array  # (n_loop,)
    losses: jax.Array  # (n_loop, n_epochs)
    train_time: float


def run_flowmc(
    target: Target,
    seed: int = 0,
    n_chain: int = 128,
    n_loop: int = 10,
    n_local_steps: int = 10,
    n_global_steps: int = 10,
    n_epochs: int = 10,
    step_size: float = 0.1,
    learning_rate: float = 1e-3,
    n_layers: int = 8,
    hidden: tuple = (64, 64),
    n_bins: int = 8,
    spline_range: tuple = (-10.0, 10.0),
    base_scale: float = 1.0,
    max_samples: Optional[int] = None,
    batch_size: Optional[int] = None,
) -> FlowMCResult:
    """Train and run the NF-enhanced sampler; returns the flow + history.

    Parameter names follow the flowMC ``Sampler`` construction the
    reference uses (exe_others.py:139-156) so configurations transfer."""
    dim = target.dim
    cap = int(max_samples or n_chain * (n_local_steps + 1))
    cap = max(cap - cap % n_chain, n_chain)  # whole ensembles only
    batch = int(batch_size or n_chain)

    key = jax.random.PRNGKey(seed)
    k_flow, k_init, k_run = jax.random.split(key, 3)
    flow, params = make_coupling_flow(
        k_flow, dim, n_layers=n_layers, hidden=hidden,
        transform_type="spline", n_bins=n_bins, spline_range=spline_range,
        base_scale=base_scale,
    )
    opt = optax.adam(learning_rate)

    value_and_score = target.value_and_score
    kernel = mala.build_kernel(value_and_score)
    init_states = mala.init(target.init_positions(k_init, n_chain),
                            value_and_score)

    def local_round(states, key):
        def body(s, k):
            s, info = kernel(k, s, step_size)
            return s, info.acceptance_rate.mean()
        states, accs = jax.lax.scan(
            body, states, jax.random.split(key, n_local_steps))
        return states, accs.mean()

    def global_round(params, states, key):
        """Scanned flow-proposal independence-MH over the ensemble."""
        def body(s, k):
            kp, ku = jax.random.split(k)
            y, log_q_y = flow.sample_and_log_prob(params, kp, n_chain)
            log_p_y = target.log_prob(y)
            log_q_x = flow.log_prob(params, s.position)
            log_acc = (log_p_y - log_q_y) - (s.logdensity - log_q_x)
            log_acc = jnp.where(jnp.isnan(log_acc), -jnp.inf, log_acc)
            acc = jnp.log(jax.random.uniform(ku, (n_chain,))) < log_acc
            pos = jnp.where(acc[:, None], y, s.position)
            # refresh gradients only where moved (one fused batched eval)
            val, score = value_and_score(pos)
            s = s._replace(position=pos, logdensity=val,
                           logdensity_grad=score)
            return s, acc.mean()
        states, accs = jax.lax.scan(
            body, states, jax.random.split(key, n_global_steps))
        return states, accs.mean()

    def buffer_insert(carry: FlowMCCarry, x) -> FlowMCCarry:
        idx = (carry.buf_ptr + jnp.arange(n_chain)) % cap
        return carry._replace(
            buf=carry.buf.at[idx].set(x),
            buf_len=jnp.minimum(carry.buf_len + n_chain, cap),
            buf_ptr=(carry.buf_ptr + n_chain) % cap,
        )

    def train_round(carry: FlowMCCarry, key):
        def epoch(c, k):
            params, opt_state = c
            # uniform minibatch over the filled prefix
            idx = jax.random.randint(k, (batch,), 0, carry.buf_len)
            xb = carry.buf[idx]

            def nll(p):
                lq = flow.log_prob(p, xb)
                return -jnp.mean(jnp.where(jnp.isfinite(lq), lq, 0.0))

            loss, grads = jax.value_and_grad(nll)(params)
            ok = jnp.isfinite(loss) & jnp.isfinite(optax.global_norm(grads))
            grads = jax.tree.map(lambda g: jnp.where(ok, g, 0.0), grads)
            updates, opt_state = opt.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            epoch, (carry.params, carry.opt_state),
            jax.random.split(key, n_epochs))
        return carry._replace(params=params, opt_state=opt_state), losses

    def one_loop(carry: FlowMCCarry, key):
        k_loc, k_tr, k_gl = jax.random.split(key, 3)
        states, acc_l = local_round(carry.states, k_loc)
        carry = buffer_insert(carry._replace(states=states), states.position)
        if n_epochs > 0:
            carry, losses = train_round(carry, k_tr)
        else:  # sampling-only mode (e.g. invariance tests on a fixed flow)
            losses = jnp.zeros((0,))
        states, acc_g = global_round(carry.params, carry.states, k_gl)
        carry = buffer_insert(carry._replace(states=states), states.position)
        return carry, (states.position, acc_l, acc_g, losses)

    @jax.jit
    def run(carry, keys):
        return jax.lax.scan(one_loop, carry, keys)

    carry = FlowMCCarry(
        states=init_states, params=params, opt_state=opt.init(params),
        buf=jnp.zeros((cap, dim)),
        buf_len=jnp.zeros((), jnp.int32),
        buf_ptr=jnp.zeros((), jnp.int32),
    )
    # seed the buffer with the initial ensemble so epoch minibatches are
    # well-defined even on the first round
    carry = buffer_insert(carry, init_states.position)

    t0 = time.time()
    # host-chunked: each loop is local moves + a training round + global
    # moves; 128 loops per XLA execution (utils.pytree.host_chunked_scan)
    carry, (positions, acc_l, acc_g, losses) = host_chunked_scan(
        run, carry, jax.random.split(k_run, n_loop), chunk=128)
    positions.block_until_ready()
    train_time = time.time() - t0
    return FlowMCResult(carry.params, flow, positions, acc_l, acc_g,
                        losses, train_time)


def flowmc_baseline(target: Target, cfg, seed: int = 0,
                    n_eval: Optional[int] = None):
    """Adapter with the shared BaselineResult schema; splits
    ``cfg.learning_iter`` into rounds exactly as the external adapter does
    (drivers/baselines.py::run_flowmc), final sampling + IS correction =
    reference exe_others.py:194-199 in log space."""
    from mfm_tpu.drivers.baselines import BaselineResult, is_resample

    steps = max(int(cfg.mcmc_per_flow_steps), 1)
    res = run_flowmc(
        target, seed=seed, n_chain=cfg.num_chain,
        n_loop=max(cfg.learning_iter // steps, 1),
        n_local_steps=steps, n_global_steps=steps, n_epochs=steps,
        step_size=cfg.step_size, learning_rate=cfg.learning_rate,
        n_layers=(
            cfg.flowmc_n_layers
            if getattr(cfg, "flowmc_n_layers", None) is not None
            # reference default: exe_others.py:132 derives depth from the
            # MLP widths with this exact formula
            else len(cfg.hidden_x) + len(cfg.hidden_t) + 4
        ),
        hidden=tuple(cfg.hidden_xt),
        max_samples=cfg.num_chain * (steps + 1),
        batch_size=cfg.num_chain,
    )
    n_eval = n_eval or cfg.eval_iter * cfg.num_chain
    key = jax.random.PRNGKey(seed)
    flow_samples, log_flow = res.flow.sample_and_log_prob(
        res.params, key, n_eval)
    log_p = target.log_prob(flow_samples)
    exact, log_w = is_resample(
        jax.random.fold_in(key, 1), flow_samples, log_p, log_flow)
    lse = jax.scipy.special.logsumexp
    extras = {
        "local_accs": res.local_accept,
        "global_accs": res.global_accept,
        "loss_vals": res.losses,
        "log_z_is": float(lse(log_w) - jnp.log(log_w.shape[0])),
        "is_ess_frac": float(
            jnp.exp(2 * lse(log_w) - lse(2 * log_w)) / log_w.shape[0]),
    }
    return BaselineResult(flow_samples, exact, res.train_time, extras)
