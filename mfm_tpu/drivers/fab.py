"""In-repo FAB: flow annealed importance-sampling bootstrap.

The reference runs FAB through the external ``fabjax`` package + hydra
configs (/root/reference/exe_others.py:42-76; config/{funnel,cox,many_well,
gmm_v0}.yaml). That package is absent here, so this module implements the
FAB training loop itself (Midgley et al., ICLR 2023) against the same
ported YAML tree (configs/fab/), so a measured MFM-vs-FAB comparison runs
with zero external dependencies. Components:

- discrete coupling flow q_theta with exact two-way densities
  (flows/coupling.py — RealNVP or RQ-spline per ``flow.transform_type``);
- AIS bridge q -> g = p^2/q (the alpha=2 divergence target): K
  intermediate densities gamma_beta = (1-beta) log q + beta log g on the
  ``spacing_type`` grid, HMC or Metropolis transitions per distribution,
  per-distribution step sizes tuned toward ``target_p_accept``;
- prioritized replay buffer over AIS outputs, sampled proportional to the
  IS weights, with the paper's weight adjustment w_adj =
  clip(q_old/q_new, w_adjust_clip) on every gradient step;
- adam + linear warmup/decay schedule and dynamic gradient skip/clip
  driven by an EMA of the gradient norm (redesign of fabjax's windowed
  median: an EMA needs O(1) carry state inside ``lax.scan`` instead of a
  100-step norm window).

On-device: the entire training run is ONE ``lax.scan`` over iterations
(buffer arrays live in the carry with static shapes; prioritized sampling
is a categorical over masked log-weights), so there is no host round-trip
between AIS forward passes and gradient updates.
"""

import os
import time
from functools import partial
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from mfm_tpu.flows.coupling import make_coupling_flow
from mfm_tpu.flows.train import make_lr_schedule
from mfm_tpu.utils.pytree import host_chunked_scan
from mfm_tpu.targets.base import Target

_CONFIG_EXAMPLE = {
    # reference mapping exe_others.py:49-56 (+ the two first-class extras)
    "pines": "cox",
    "4-mode": "funnel",
    "phi-four": "many_well",
    "gaussian-mixture": "gmm_v0",
    "funnel": "funnel",
    "many-well": "many_well",
}


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_fab_config(example: str, config_dir: Optional[str] = None) -> dict:
    """Compose a FAB config the way hydra would (defaults groups `fab`,
    `flow`, `training` then the per-target file; reference
    config/{cox,funnel,...}.yaml defaults lists) — without hydra."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "the FAB baseline reads its configs/fab/*.yaml with PyYAML; "
            "install pyyaml (the 'yaml' extra) to run --do-fab"
        ) from e
    if config_dir is None:
        config_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "configs", "fab")
    name = _CONFIG_EXAMPLE.get(example, example)
    cfg: dict = {}
    for group in ("fab", "flow", "training"):
        with open(os.path.join(config_dir, group, "default.yaml")) as f:
            cfg[group] = yaml.safe_load(f)
    with open(os.path.join(config_dir, f"{name}.yaml")) as f:
        per_target = yaml.safe_load(f) or {}
    per_target.pop("defaults", None)
    return _deep_merge(cfg, per_target)


class FABCarry(NamedTuple):
    params: Any
    opt_state: Any
    grad_norm_ema: jax.Array  # EMA of accepted gradient norms
    step_sizes: jax.Array  # (K+1,) per-intermediate-distribution
    buf_x: jax.Array  # (C, d) replay positions
    buf_log_w: jax.Array  # (C,) AIS log-weights (priorities), -inf = empty
    buf_log_q: jax.Array  # (C,) flow log-density at insertion time
    buf_ptr: jax.Array  # ring-buffer write pointer
    step: jax.Array


class FABResult(NamedTuple):
    params: Any
    flow: Any  # CouplingFlow handle
    losses: jax.Array  # (n_iter,)
    accept: jax.Array  # (n_iter,) mean AIS transition acceptance
    log_z_alpha2: jax.Array  # (n_iter,) AIS estimate of log int p^2/q
    train_time: float


def run_fab(
    target: Target,
    example: str,
    seed: int = 0,
    n_epoch: Optional[int] = None,
    batch_size: Optional[int] = None,
    config_dir: Optional[str] = None,
    overrides: Optional[dict] = None,
) -> FABResult:
    """Train a FAB sampler on ``target`` with the ported per-example config
    (reference exe_others.py:60-66 applies the same three CLI overrides)."""
    cfg = load_fab_config(example, config_dir)
    if overrides:
        cfg = _deep_merge(cfg, overrides)
    fab, flow_cfg, tr = cfg["fab"], cfg["flow"], cfg["training"]
    n_epoch = int(n_epoch or tr["n_epoch"])
    batch = int(batch_size or tr["batch_size"])
    dim = target.dim

    key = jax.random.PRNGKey(seed)
    key_flow, key_run = jax.random.split(key)
    flow, params = make_coupling_flow(
        key_flow, dim,
        n_layers=int(flow_cfg["n_layers"]),
        hidden=tuple(flow_cfg["conditioner_mlp_units"]),
        transform_type=flow_cfg["transform_type"],
        n_bins=int(flow_cfg.get("spline_num_bins", 8)),
        spline_range=(float(flow_cfg.get("spline_min", -10.0)),
                      float(flow_cfg.get("spline_max", 10.0))),
        act_norm=bool(flow_cfg.get("act_norm", False)),
        base_scale=float(flow_cfg.get("base_scale", 1.0)),
    )

    # --- AIS bridge ----------------------------------------------------------
    K = int(fab["smc"]["n_intermediate_distributions"])
    if fab["smc"].get("spacing_type", "linear") == "linear":
        betas = jnp.linspace(0.0, 1.0, K + 2)[1:]  # (K+1,) ending at 1
    else:  # geometric spacing concentrates near beta=0
        betas = jnp.geomspace(1.0 / (K + 2), 1.0, K + 1)
    op = fab["smc"]["transition_operator"]
    op_cfg = fab["smc"][op]
    n_outer = int(op_cfg.get("n_outer_steps", 1))
    n_inner = int(op_cfg.get("n_inner_steps", 5)) if op == "hmc" else 1
    init_step = float(op_cfg.get("init_step_size", 1.0))
    tune = bool(op_cfg.get("tune_step_size", True))
    p_accept = float(op_cfg.get("target_p_accept", 0.65))
    alpha = float(fab.get("alpha", 2.0))
    w_clip = float(fab.get("w_adjust_clip", 10.0))

    def log_gamma(params, beta, x):
        """Annealed density: (1-beta) log q + beta log g,
        g = p^alpha / q^(alpha-1)  =>  log q + beta*alpha*(log p - log q)."""
        lq = flow.log_prob(params, x)
        return lq + beta * alpha * (target.log_prob(x) - lq)

    def transition(params, beta, step, key, x):
        """One MH transition (HMC or RWM) targeting gamma_beta; batched."""
        logp_fn = lambda z: log_gamma(params, beta, z)
        if op == "hmc":
            grad_fn = jax.vmap(jax.grad(lambda v: log_gamma(params, beta, v)))

            def leap(carry, _):
                # velocity Verlet with the gradient carried across steps:
                # n_inner+1 gradient evals total instead of 2*n_inner
                z, m, g = carry
                m = m + 0.5 * step * g
                z = z + step * m
                g = grad_fn(z)
                m = m + 0.5 * step * g
                return (z, m, g), None

            def one(key, x):
                km, ku = jax.random.split(key)
                m0 = jax.random.normal(km, x.shape)
                (z, m, _), _ = jax.lax.scan(
                    leap, (x, m0, grad_fn(x)), None, length=n_inner)
                log_acc = (logp_fn(z) - logp_fn(x)
                           - 0.5 * jnp.sum(m * m, -1)
                           + 0.5 * jnp.sum(m0 * m0, -1))
                acc = jnp.log(jax.random.uniform(ku, log_acc.shape)) < log_acc
                return jnp.where(acc[:, None], z, x), acc
        else:  # random-walk metropolis
            def one(key, x):
                kp, ku = jax.random.split(key)
                z = x + step * jax.random.normal(kp, x.shape)
                log_acc = logp_fn(z) - logp_fn(x)
                acc = jnp.log(jax.random.uniform(ku, log_acc.shape)) < log_acc
                return jnp.where(acc[:, None], z, x), acc

        def outer(carry, key):
            x, acc_sum = carry
            x, acc = one(key, x)
            return (x, acc_sum + acc.mean()), None

        (x, acc_sum), _ = jax.lax.scan(
            outer, (x, jnp.zeros(())), jax.random.split(key, n_outer))
        # mean over ALL outer steps: the Robbins-Monro step-size tuning and
        # the reported stat must react to the average acceptance, not
        # whichever step happened to run last
        return x, acc_sum / n_outer

    def ais_forward(params, step_sizes, key):
        """Sample q -> AIS through the bridge; returns final positions,
        log-weights, per-distribution acceptance, updated step sizes.
        Not differentiated through (FAB treats AIS as a fixed sampler)."""
        params = jax.lax.stop_gradient(params)
        k0, krest = jax.random.split(key)
        x, lq = flow.sample_and_log_prob(params, k0, batch)
        log_w = log_gamma(params, betas[0], x) - lq

        def stage(carry, inp):
            x, log_w = carry
            i, key = inp
            x, acc = transition(params, betas[i], step_sizes[i], key, x)
            # weight increment: gamma_{i+1}(x_i) - gamma_i(x_i)
            inc = jnp.where(
                i < K,
                log_gamma(params, betas[jnp.minimum(i + 1, K)], x)
                - log_gamma(params, betas[i], x),
                jnp.zeros(x.shape[0]),
            )
            return (x, log_w + inc), acc

        idx = jnp.arange(K + 1)
        (x, log_w), accs = jax.lax.scan(
            stage, (x, log_w), (idx, jax.random.split(krest, K + 1)))
        if tune:
            # Robbins-Monro on log step size toward the target acceptance
            step_sizes = step_sizes * jnp.exp(0.15 * (accs - p_accept))
        return x, log_w, accs.mean(), step_sizes

    # --- prioritized replay buffer --------------------------------------------
    use_buffer = bool(fab["buffer"].get("with_buffer", True))
    n_updates = int(fab["buffer"].get("n_updates_per_smc_forward_pass", 4))
    min_batches = int(fab["buffer"].get("buffer_min_length_in_batches", 40))
    max_batches = int(fab["buffer"].get("buffer_max_length_in_batches", 400))
    # keep the buffer bounded relative to the run length so tiny smoke runs
    # don't allocate a 400-batch ring for a 30-iteration train
    max_batches = max(min(max_batches, n_epoch + min_batches), 2)
    min_batches = min(min_batches, max(n_epoch // 4, 1))
    cap = max_batches * batch

    def buffer_insert(carry: FABCarry, x, log_w, log_q) -> FABCarry:
        idx = (carry.buf_ptr + jnp.arange(batch)) % cap
        return carry._replace(
            buf_x=carry.buf_x.at[idx].set(x),
            buf_log_w=carry.buf_log_w.at[idx].set(log_w),
            buf_log_q=carry.buf_log_q.at[idx].set(log_q),
            buf_ptr=(carry.buf_ptr + batch) % cap,
        )

    # --- optimizer -------------------------------------------------------------
    opt_cfg = tr["optimizer"]
    if opt_cfg.get("use_schedule", True):
        # schedule horizon = actual grad steps: n_updates per epoch only in
        # buffer mode; without the buffer exactly one grad step runs per epoch
        steps_per_epoch = n_updates if use_buffer else 1
        lr_fn = make_lr_schedule(
            n_epoch * max(steps_per_epoch, 1),
            int(opt_cfg.get("warmup_n_epoch", 10)),
            float(opt_cfg.get("peak_lr", 2e-4)))
    else:
        lr_fn = optax.constant_schedule(float(opt_cfg.get("init_lr", 2e-5)))
    opt = optax.adam(lr_fn)
    ignore_factor = float(opt_cfg.get("dynamic_grad_ignore_factor", 10.0))
    clip_factor = float(opt_cfg.get("dynamic_grad_norm_factor", 2.0))
    dynamic = bool(opt_cfg.get("dynamic_grad_ignore_and_clip", True))

    def loss_fn(params, x, w_norm, log_q_old):
        log_q = flow.log_prob(params, x)
        # paper's buffer correction: weights were computed under q_old
        w_adj = jnp.clip(jnp.exp(jax.lax.stop_gradient(log_q_old - log_q)),
                         0.0, w_clip)
        return -jnp.sum(w_norm * w_adj * log_q), log_q

    def grad_update(carry: FABCarry, x, w_norm, log_q_old):
        (loss, log_q), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            carry.params, x, w_norm, log_q_old)
        gnorm = optax.global_norm(grads)
        finite = jnp.isfinite(gnorm) & jnp.isfinite(loss)
        if dynamic:
            ema = jnp.where(carry.step == 0, jnp.maximum(gnorm, 1e-8),
                            carry.grad_norm_ema)
            keep = finite & (gnorm <= ignore_factor * ema)
            scale = jnp.minimum(1.0, clip_factor * ema / jnp.maximum(gnorm, 1e-20))
            grads = jax.tree.map(lambda g: jnp.where(keep, g * scale, 0.0), grads)
            ema = jnp.where(keep, 0.99 * ema + 0.01 * gnorm, ema)
        else:
            keep = finite
            grads = jax.tree.map(lambda g: jnp.where(keep, g, 0.0), grads)
            ema = carry.grad_norm_ema
        updates, opt_state = opt.update(grads, carry.opt_state, carry.params)
        params = optax.apply_updates(carry.params, updates)
        return carry._replace(params=params, opt_state=opt_state,
                              grad_norm_ema=ema,
                              step=carry.step + 1), loss, log_q

    def train_iter(carry: FABCarry, key):
        k_ais, k_buf = jax.random.split(key)
        x, log_w, acc, step_sizes = ais_forward(carry.params, carry.step_sizes,
                                                k_ais)
        log_w = jnp.where(jnp.isfinite(log_w), log_w, -jnp.inf)
        # AIS estimate of log Z_g = log int p^alpha/q^(alpha-1)
        log_z = jax.scipy.special.logsumexp(log_w) - jnp.log(batch)
        carry = carry._replace(step_sizes=step_sizes)

        if use_buffer:
            carry = buffer_insert(
                carry, x, log_w,
                flow.log_prob(jax.lax.stop_gradient(carry.params), x))

            def upd(carry, k):
                idx = jax.random.categorical(k, carry.buf_log_w, shape=(batch,))
                xb = carry.buf_x[idx]
                lqo = carry.buf_log_q[idx]
                w_norm = jnp.full((batch,), 1.0 / batch)  # priority-sampled
                carry, loss, log_q = grad_update(carry, xb, w_norm, lqo)
                # refresh stored density & priorities for the batch we just
                # re-scored (fabjax adjusts priorities the same way)
                dlw = jnp.clip(lqo - log_q, -jnp.log(w_clip), jnp.log(w_clip))
                # idx is drawn with replacement; duplicates of a slot carry
                # identical recomputed values, so a set is idempotent where
                # an add would compound the adjustment k times per duplicate
                carry = carry._replace(
                    buf_log_q=carry.buf_log_q.at[idx].set(log_q),
                    buf_log_w=carry.buf_log_w.at[idx].set(
                        carry.buf_log_w[idx] + dlw),
                )
                return carry, loss

            carry, losses = jax.lax.scan(
                upd, carry, jax.random.split(k_buf, n_updates))
            loss = losses.mean()
        else:
            # on-policy alpha-divergence gradient: self-normalized weights
            w_norm = jax.nn.softmax(log_w)
            lq = flow.log_prob(jax.lax.stop_gradient(carry.params), x)
            carry, loss, _ = grad_update(carry, x, w_norm, lq)
        return carry, (loss, acc, log_z)

    # --- run -------------------------------------------------------------------
    carry = FABCarry(
        params=params,
        opt_state=opt.init(params),
        grad_norm_ema=jnp.zeros(()),
        step_sizes=jnp.full((K + 1,), init_step),
        buf_x=jnp.zeros((cap, dim)),
        buf_log_w=jnp.full((cap,), -jnp.inf),
        buf_log_q=jnp.zeros((cap,)),
        buf_ptr=jnp.zeros((), jnp.int32),
        step=jnp.zeros((), jnp.int32),
    )

    @jax.jit
    def prefill(carry, keys):
        def one(carry, key):
            x, log_w, _, step_sizes = ais_forward(carry.params,
                                                  carry.step_sizes, key)
            log_w = jnp.where(jnp.isfinite(log_w), log_w, -jnp.inf)
            lq = flow.log_prob(carry.params, x)
            return buffer_insert(carry._replace(step_sizes=step_sizes),
                                 x, log_w, lq), None
        return jax.lax.scan(one, carry, keys)[0]

    @jax.jit
    def train(carry, keys):
        return jax.lax.scan(train_iter, carry, keys)

    k_pre, k_train = jax.random.split(key_run)
    t0 = time.time()
    if use_buffer and min_batches > 0:
        carry = prefill(carry, jax.random.split(k_pre, min_batches))
    # host-chunked: 256 epochs per XLA execution instead of one
    # whole-run scan (utils.pytree.host_chunked_scan)
    carry, (losses, accs, log_zs) = host_chunked_scan(
        train, carry, jax.random.split(k_train, n_epoch), chunk=256)
    losses.block_until_ready()
    train_time = time.time() - t0
    return FABResult(carry.params, flow, losses, accs, log_zs, train_time)


def fab_baseline(target: Target, cfg, seed: int = 0,
                 n_eval: Optional[int] = None):
    """Adapter with the shared BaselineResult schema (final sampling + IS
    correction = reference exe_others.py:71-76, in log space)."""
    from mfm_tpu.drivers.baselines import BaselineResult, is_resample

    res = run_fab(
        target, cfg.example, seed=seed,
        n_epoch=cfg.learning_iter, batch_size=cfg.num_chain,
        overrides={"flow": {"conditioner_mlp_units": list(cfg.hidden_xt)}},
    )
    n_eval = n_eval or cfg.eval_iter * cfg.num_chain
    key = jax.random.PRNGKey(seed)
    flow_samples, log_flow = res.flow.sample_and_log_prob(
        res.params, key, n_eval)
    log_p = target.log_prob(flow_samples)
    exact, _ = is_resample(
        jax.random.fold_in(key, 1), flow_samples, log_p, log_flow)
    # flow-IS normalizer estimate + ESS fraction (checkable against exact
    # logZ on many-well/16-mode, same estimator the MFM rows report)
    log_w = jnp.where(jnp.isnan(log_p), -jnp.inf, log_p - log_flow)
    lse = jax.scipy.special.logsumexp
    extras = {
        "final_loss": float(res.losses[-1]),
        "mean_accept": float(res.accept.mean()),
        "log_z_alpha2": float(res.log_z_alpha2[-min(10, len(res.log_z_alpha2)):].mean()),
        "log_z_is": float(lse(log_w) - jnp.log(log_w.shape[0])),
        "is_ess_frac": float(
            jnp.exp(2 * lse(log_w) - lse(2 * log_w)) / log_w.shape[0]),
    }
    return BaselineResult(flow_samples, exact, res.train_time, extras)
