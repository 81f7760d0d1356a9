"""In-repo DDS: denoising diffusion sampler.

The reference runs this baseline through the external ``dds`` package
(/root/reference/exe_others.py:247-299: OU reference process "oudstl",
cos^2 step schedule, IS weights from energy/terminal costs :292-297). That
package is absent here, so this module implements the sampler itself
(Vargas, Grathwohl & Doucet, ICLR 2023) in its exact discrete-time form:

- reference (noising) chain: the DISCRETE OU kernel
  q(x_k | x_{k+1}) = N(x_k; sqrt(1-beta_k) x_{k+1}, beta_k sigma^2 I),
  which leaves N(0, sigma^2 I) invariant for every beta schedule — so the
  extended target q(x_{0:K}) = pi(x_K) prod_k q(x_k | x_{k+1}) has pi as
  its exact x_K-marginal, no continuous-time discretization error;
- learned (sampling) chain: x_0 ~ N(0, sigma^2 I), then
  x_{k+1} = sqrt(1-beta_k) x_k + sqrt(beta_k) sigma (g_theta(x_k, t_k) + eps_k),
  i.e. the reversible OU proposal plus a learned normalized control g;
- objective: KL(p_theta || q) along the path, estimated pathwise by
  reparameterization. Because the OU kernel is reversible w.r.t.
  N(0, sigma^2), the per-step Gaussian log-ratio has the closed form
  (1/2)(||eps_k||^2 - ||sqrt(beta_k) x_k / sigma - sqrt(1-beta_k)(g_k + eps_k)||^2)
  and at g == 0 the path terms telescope to
  log pi(x_K) - log N(x_K; 0, sigma^2 I) exactly (detailed balance) —
  tested as an invariance in tests/test_dds.py;
- IS weights: exp(log w) with log w = log q - log p_theta accumulated in
  the same scan, so the final-sample IS correction and the logZ estimate
  logsumexp(log w) - log B are exact for the discrete-time model.

The control network reuses the CNF's VectorFieldNet (Fourier time
features + score gating, zero-init heads), so an untrained DDS is exactly
the stationary-OU IS sampler — the same identity-at-init principle as the
CNF transport and the coupling flows.

On-device: training is ONE ``lax.scan`` over iterations; each iteration
differentiates through a K-step inner scan with ``jax.checkpoint`` on the
step body (memory O(K) positions instead of O(K) full activations, the
standard remat trade for long unrolled chains).
"""

import time
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from mfm_tpu.flows.train import make_lr_schedule
from mfm_tpu.flows.vector_field import make_vector_field
from mfm_tpu.targets.base import Target
from mfm_tpu.utils.pytree import host_chunked_scan


def cos_sq_betas(n_steps: int, beta_min: float = 1e-3,
                 beta_max: float = 0.3) -> jax.Array:
    """cos^2-annealed noise schedule (reference exe_others.py:257
    ``step_scheme_key='cos_sq'``): large beta at the noise end (k=0),
    decaying as cos^2 toward the target end so the chain takes fine steps
    where it must match pi."""
    t = jnp.arange(n_steps) / max(n_steps - 1, 1)
    return beta_min + (beta_max - beta_min) * jnp.cos(0.5 * jnp.pi * t) ** 2


class DDSResult(NamedTuple):
    params: Any
    losses: jax.Array  # (n_iter,) KL estimates (+ logZ constant)
    log_z: jax.Array  # (n_iter,) IS logZ estimate per iteration
    train_time: float
    sample_fn: Any  # (params, key, n) -> (x, log_w)


def run_dds(
    target: Target,
    seed: int = 0,
    n_iter: int = 1000,
    batch_size: int = 128,
    n_steps: int = 100,
    sigma: float = 1.0,
    learning_rate: float = 1e-3,
    hidden: tuple = (64, 64),
    beta_max: float = 0.3,
    score_clip: float = 100.0,
    control_clip: float = 100.0,
) -> DDSResult:
    """Train the denoising diffusion sampler on ``target``.

    ``sigma``: stationary std of the OU reference (the dds package's
    ``config.model.sigma``); set it to the target's scale the same way the
    MFM path picks its reference distribution."""
    dim = target.dim
    betas = cos_sq_betas(n_steps, beta_max=beta_max)
    ts = jnp.arange(n_steps, dtype=jnp.float32) / n_steps

    key = jax.random.PRNGKey(seed)
    k_net, k_run = jax.random.split(key)
    # score gating uses the TARGET score (the dds nets feed grad log pi the
    # same way). BOTH clips are load-bearing at every dim, not just large
    # ones: the gated score is a positive-feedback loop (gate drifts ->
    # g ~ -score points outward -> |x| grows -> |score| grows), and the
    # PIS/DDS implementations bound it with lgv_clip ~ 1e2 on the score and
    # ~1e2 on the network output. Verified: without them, 4-mode training
    # diverges to |x| ~ 1e5 within 300 iterations.
    # the score is a DETACHED feature (the "d" in the dds package's
    # "oudstl" reference process): stop_gradient keeps grad log pi out of
    # the backward pass, so training never differentiates through the
    # target Hessian — the term that couples the gate drift to the score
    # growth and destabilizes long schedules
    def detached_score(x):
        return jax.lax.stop_gradient(target.score(x))

    apply_fn, params = make_vector_field(
        k_net, dim, hidden_x=(), hidden_t=(),
        hidden_xt=tuple(hidden),
        score_fn=detached_score,
        score_clip=score_clip,
    )

    def _normal_logpdf(x):
        return (-0.5 * jnp.sum(x * x, -1) / (sigma * sigma)
                - 0.5 * dim * jnp.log(2 * jnp.pi) - dim * jnp.log(sigma))

    @jax.checkpoint
    def step_k(params, x, log_w, beta, t, eps):
        """One controlled OU step + exact log-weight increment."""
        g = apply_fn(params, x, jnp.full((x.shape[0],), t))
        g = jnp.clip(g, -control_clip, control_clip)
        root1m = jnp.sqrt(1.0 - beta)
        x_next = root1m * x + jnp.sqrt(beta) * sigma * (g + eps)
        resid = jnp.sqrt(beta) * x / sigma - root1m * (g + eps)
        inc = 0.5 * (jnp.sum(eps * eps, -1) - jnp.sum(resid * resid, -1))
        return x_next, log_w + inc

    def rollout(params, key):
        """Sample the controlled chain; returns (x_K, log w) with
        log w = log q(x_{0:K}) - log p_theta(x_{0:K}) (pi unnormalized)."""
        k0, keps = jax.random.split(key)
        x0 = sigma * jax.random.normal(k0, (batch_size, dim))
        eps = jax.random.normal(keps, (n_steps, batch_size, dim))

        def body(carry, inp):
            x, log_w = carry
            beta, t, e = inp
            x, log_w = step_k(params, x, log_w, beta, t, e)
            return (x, log_w), None

        # log w starts at -log p(x_0) = -log N(x_0; 0, sigma^2 I); the
        # per-step increments and the terminal log pi(x_K) complete
        # log q(x_{0:K}) - log p_theta(x_{0:K})
        (xK, log_w), _ = jax.lax.scan(
            body, (x0, -_normal_logpdf(x0)), (betas, ts, eps))
        log_p = target.log_prob(xK)
        log_w = log_w + jnp.where(jnp.isnan(log_p), -jnp.inf, log_p)
        return xK, log_w

    lr_fn = make_lr_schedule(n_iter, max(n_iter // 20, 1), learning_rate)
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(lr_fn))

    def loss_fn(params, key):
        _, log_w = rollout(params, key)
        finite = jnp.isfinite(log_w)
        safe = jnp.where(finite, log_w, 0.0)
        n_finite = jnp.maximum(jnp.sum(finite), 1).astype(safe.dtype)
        # KL(p||q) - logZ, pathwise-reparameterized. Masked mean: an
        # exploded trajectory is excluded from the estimate rather than
        # averaged in as a zero (which would pull the KL gradient toward
        # zero whenever any chain diverges)
        return -jnp.sum(safe) / n_finite, log_w

    @jax.jit
    def train(carry, keys):
        def it(carry, key):
            params, opt_state, gnorm_ema = carry
            (loss, log_w), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, key)
            gnorm = optax.global_norm(grads)
            # EMA-based spike skip (same device as the in-repo FAB loop):
            # a rare exploded trajectory produces a gradient orders of
            # magnitude above typical; applying it is what tips long
            # schedules into the runaway regime. The EMA seeds itself from
            # the first finite gradient norm (sentinel < 0).
            gnorm_ema = jnp.where(
                (gnorm_ema < 0) & jnp.isfinite(gnorm), gnorm, gnorm_ema)
            ok = (jnp.isfinite(loss) & jnp.isfinite(gnorm)
                  & (gnorm < 5.0 * gnorm_ema))
            grads = jax.tree.map(lambda g: jnp.where(ok, g, 0.0), grads)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            gnorm_ema = jnp.where(
                ok, 0.95 * gnorm_ema + 0.05 * gnorm, gnorm_ema)
            lw = jnp.where(jnp.isfinite(log_w), log_w, -jnp.inf)
            log_z = (jax.scipy.special.logsumexp(lw)
                     - jnp.log(batch_size))
            return (params, opt_state, gnorm_ema), (loss, log_z)

        return jax.lax.scan(it, carry, keys)

    t0 = time.time()
    # host-chunked (utils.pytree.host_chunked_scan): bounds the length of
    # each XLA execution
    (params, _, _), (losses, log_zs) = host_chunked_scan(
        train,
        (params, opt.init(params), jnp.asarray(-1.0)),
        jax.random.split(k_run, n_iter), chunk=2048)
    losses.block_until_ready()
    train_time = time.time() - t0

    def sample_fn(params, key, n: int):
        """IS-weighted final sampling; batches of the training width."""
        reps = -(-n // batch_size)
        xs, ws = jax.lax.map(
            lambda k: rollout(params, k), jax.random.split(key, reps))
        return xs.reshape(-1, dim)[:n], ws.reshape(-1)[:n]

    return DDSResult(params, losses, log_zs, train_time, sample_fn)


def dds_baseline(target: Target, cfg, seed: int = 0,
                 n_eval: Optional[int] = None):
    """Adapter with the shared BaselineResult schema (final sampling + IS
    correction = reference exe_others.py:292-297, in log space)."""
    from mfm_tpu.drivers.baselines import BaselineResult, is_resample
    from mfm_tpu.targets import REF_DISTS

    # match the OU stationary scale to the example's reference dist the
    # same way the MFM path does (targets/__init__.py::REF_DISTS)
    factory = REF_DISTS.get(cfg.ref_dist)
    ref = factory(cfg.dim) if factory is not None else None
    sigma = float(getattr(ref, "std", 1.0)) if ref is not None else 1.0
    res = run_dds(
        target, seed=seed, n_iter=cfg.learning_iter,
        batch_size=cfg.num_chain, learning_rate=cfg.learning_rate,
        hidden=tuple(cfg.hidden_xt), sigma=sigma,
    )
    n_eval = n_eval or cfg.eval_iter * cfg.num_chain
    key = jax.random.PRNGKey(seed)
    flow_samples, log_w = res.sample_fn(res.params, key, n_eval)
    exact, log_w = is_resample(
        jax.random.fold_in(key, 1), flow_samples, log_w)
    lse = jax.scipy.special.logsumexp
    extras = {
        "final_loss": float(res.losses[-1]),
        "log_z_is": float(lse(log_w) - jnp.log(log_w.shape[0])),
        "is_ess_frac": float(
            jnp.exp(2 * lse(log_w) - lse(2 * log_w)) / log_w.shape[0]),
    }
    return BaselineResult(flow_samples, exact, res.train_time, extras)
