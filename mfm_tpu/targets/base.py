"""Target-density protocol.

Batched counterpart of the reference ``Distribution`` ABC
(/root/reference/distributions.py:8-39). Differences by design:

- Targets are plain Python objects whose array state is fixed at
  construction; drivers close over them, so inside ``jit`` / ``shard_map``
  their arrays become trace-time constants (no pytree flattening needed —
  configuration such as dims/boundary conditions is static by construction).
- Every density is **batch-first**: ``log_prob(x)`` accepts ``(d,)`` or
  ``(B, d)`` and the batched path is written with large matmuls/elementwise
  ops, instead of relying on ``jax.vmap`` of a
  scalar-oriented function.
- The likelihood/prior split (``log_lik`` / ``log_prior``) is kept because
  tempering schedules interpolate ``beta * log_lik + log_prior``
  (reference exe_flow_matching.py:301).
"""

from typing import Optional

import jax
import jax.numpy as jnp


class Target:
    """Base class for unnormalized target densities.

    Subclasses implement the single-sample ``_log_lik`` / ``_log_prior``
    (signature ``(d,) -> scalar``) and may override the batched
    ``log_lik`` / ``log_prior`` with a fused implementation. ``log_prob``
    is always ``log_lik + log_prior``.
    """

    dim: int

    # ---- single-sample hooks -------------------------------------------------
    def _log_lik(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def _log_prior(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    # ---- batched API ---------------------------------------------------------
    def log_lik(self, x: jax.Array) -> jax.Array:
        """Log-likelihood term; ``(d,) -> ()`` or ``(B, d) -> (B,)``."""
        if x.ndim == 1:
            return self._log_lik(x)
        return jax.vmap(self._log_lik)(x)

    def log_prior(self, x: jax.Array) -> jax.Array:
        """Log-prior term; ``(d,) -> ()`` or ``(B, d) -> (B,)``."""
        if x.ndim == 1:
            return self._log_prior(x)
        return jax.vmap(self._log_prior)(x)

    def log_prob(self, x: jax.Array) -> jax.Array:
        """Unnormalized log-density; ``(d,) -> ()`` or ``(B, d) -> (B,)``."""
        return self.log_lik(x) + self.log_prior(x)

    def score(self, x: jax.Array) -> jax.Array:
        """Gradient of ``log_prob``; same leading shape as ``x``."""
        single = lambda v: self.log_prob(v)
        if x.ndim == 1:
            return jax.grad(single)(x)
        return jax.vmap(jax.grad(single))(x)

    def value_and_score(self, x: jax.Array):
        """(log_prob, grad log_prob) in one pass; batched like ``score``."""
        single = jax.value_and_grad(lambda v: self.log_prob(v))
        if x.ndim == 1:
            return single(x)
        return jax.vmap(single)(x)

    # ---- sampling hooks ------------------------------------------------------
    def sample(self, key: jax.Array, shape=()) -> jax.Array:
        """Exact sampler when available. ``shape`` is the batch shape."""
        raise NotImplementedError(f"{type(self).__name__} has no exact sampler")

    @property
    def can_sample(self) -> bool:
        return type(self).sample is not Target.sample

    def init_positions(self, key: jax.Array, n_chain: int) -> jax.Array:
        """Initial chain positions, shape (n_chain, dim). Default: N(0, I)."""
        return jax.random.normal(key, (n_chain, self.dim))

    def prior_sample(self, key: jax.Array, shape=()) -> jax.Array:
        """Exact sampler of the (normalized) prior, when available. Enables
        the 'prior' flow reference distribution (prior -> posterior
        transport is much shorter than N(0,I) -> posterior for targets with
        structured priors like the LGCP)."""
        raise NotImplementedError(f"{type(self).__name__} has no prior sampler")

    # ---- tempering -----------------------------------------------------------
    def tempered_log_prob(self, x: jax.Array, beta) -> jax.Array:
        """``beta * log_lik + log_prior`` (reference exe_flow_matching.py:301)."""
        return beta * self.log_lik(x) + self.log_prior(x)

    def tempered_value_and_score(self, x: jax.Array, beta):
        """(tempered log-density, its gradient), batched. Targets with
        analytic scores override this to avoid autodiff (e.g. LGCP)."""
        single = jax.value_and_grad(lambda v: self.tempered_log_prob(v, beta))
        if x.ndim == 1:
            return single(x)
        return jax.vmap(single)(x)


def as_logprob_fn(target: Target, beta: Optional[jax.Array] = None):
    """Single-sample ``(d,) -> scalar`` closure, optionally tempered."""
    if beta is None:
        return lambda x: target.log_prob(jnp.atleast_1d(x))
    return lambda x: target.tempered_log_prob(jnp.atleast_1d(x), beta)


class GeometricPath(Target):
    """Reparametrize a target's tempering path around q0 = N(0, I).

    The reference's tempering convention ``pi_beta ∝ exp(beta*log_lik +
    log_prior)`` (exe_flow_matching.py:301) breaks the SMC log-normalizer
    for flat-prior targets (GaussianMixture / ManyWell / PhiFour set
    ``log_prior ≡ 0``, reference distributions.py:58): the beta=0 endpoint
    is an improper flat measure, but particles initialize from N(0, I)
    (distributions.py:69-71), so the telescoping logZ estimate picks up a
    spurious first factor ``E_{N(0,I)}[exp(delta_1 * log_lik)]`` — measured
    at -14.5 nats on the 4-mode benchmark whose true logZ is 0 (RESULTS.md
    round 5, baseline showdown).

    This wrapper redefines the lik/prior split as

        log_prior'(x) = log N(x; 0, I)
        log_lik'(x)   = log_prob(x) - log N(x; 0, I)

    so the tempered family ``beta*log_lik' + log_prior'`` is the geometric
    bridge ``N(0,I)^(1-beta) * p(x)^beta``: its beta=0 endpoint is exactly
    the initial particle distribution and the SMC increments telescope to
    the target's true log-normalizer. ``log_prob`` (and therefore every
    beta=1 quantity) is unchanged.
    """

    def __init__(self, target: Target):
        self.dim = target.dim
        self._target = target

    def _log_q0(self, x: jax.Array) -> jax.Array:
        return -0.5 * jnp.sum(x * x, axis=-1) - 0.5 * self.dim * jnp.log(
            2.0 * jnp.pi
        )

    def log_lik(self, x: jax.Array) -> jax.Array:
        return self._target.log_prob(x) - self._log_q0(x)

    def log_prior(self, x: jax.Array) -> jax.Array:
        return self._log_q0(x)

    def log_prob(self, x: jax.Array) -> jax.Array:
        return self._target.log_prob(x)

    def score(self, x: jax.Array) -> jax.Array:
        return self._target.score(x)

    def value_and_score(self, x: jax.Array):
        return self._target.value_and_score(x)

    def tempered_value_and_score(self, x: jax.Array, beta):
        """(1-beta)*q0 + beta*p, with p's (possibly analytic) score reused."""
        value, grad = self._target.value_and_score(x)
        q0 = self._log_q0(x)
        tv = beta * value + (1.0 - beta) * q0
        tg = beta * grad - (1.0 - beta) * x
        return tv, tg

    def sample(self, key: jax.Array, shape=()) -> jax.Array:
        return self._target.sample(key, shape)

    @property
    def can_sample(self) -> bool:
        return self._target.can_sample

    def init_positions(self, key: jax.Array, n_chain: int) -> jax.Array:
        # the path's beta=0 endpoint — must be N(0, I) regardless of the
        # wrapped target's own (possibly prior-based) init
        return jax.random.normal(key, (n_chain, self.dim))


class PriorReference(Target):
    """Flow reference distribution wrapping a target's own prior.

    log_prob is the target's (normalized) log_prior; sample delegates to
    ``target.prior_sample``. New capability vs the reference's fixed
    ref-dist table (exe_flow_matching.py:48-54): with an informed prior the
    CNF only has to learn the likelihood update.
    """

    def __init__(self, target: Target):
        self.dim = target.dim
        self._target = target

    @property
    def gaussian_mean(self):
        """Mean of the (Gaussian) prior, for elliptical-slice proposals
        (drivers/flow_smc TESS inner kernel). Targets with a non-centered
        Gaussian prior expose ``prior_gaussian_mean``."""
        return getattr(self._target, "prior_gaussian_mean", 0.0)

    def log_lik(self, x):
        return self._target.log_prior(x)

    def log_prior(self, x):
        return jnp.zeros(x.shape[:-1], x.dtype)

    def sample(self, key, shape=()):
        return self._target.prior_sample(key, shape)
