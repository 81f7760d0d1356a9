"""Gaussian-family targets: isotropic, flat, and diagonal-covariance mixtures.

Capability parity with the reference ``GaussianMixture`` / ``IndepGaussian`` /
``FlatDistribution`` (/root/reference/distributions.py:42-111), redesigned
batch-first: the mixture log-density is one ``(B, K, d)`` broadcasted
reduction + ``logsumexp`` instead of a vmapped per-component pdf product,
and it is evaluated in log-space (the reference exponentiates per-component
pdfs, which underflows in f32 far from the modes — log-space keeps f32
viable).
"""

from typing import Optional

import math

import jax
import jax.numpy as jnp

from mfm_tpu.targets.base import Target

_LOG2PI = math.log(2.0 * math.pi)


class IndepGaussian(Target):
    """Isotropic Gaussian N(mean, var * I).

    Parity: reference ``IndepGaussian`` (/root/reference/distributions.py:80-97).
    Used both as a simple target and as the 'stdgauss'/'widegauss' flow
    reference distributions.
    """

    def __init__(self, dim: int, mean: float = 0.0, var: float = 1.0):
        self.dim = dim
        self.mean = jnp.asarray(mean)
        self.var = jnp.asarray(var)
        self.std = jnp.sqrt(self.var)

    def log_lik(self, x):
        z = (x - self.mean) / self.std
        quad = jnp.sum(z * z, axis=-1)
        norm = self.dim * (_LOG2PI + 2.0 * jnp.log(self.std))
        return -0.5 * (quad + norm)

    def log_prior(self, x):
        return jnp.zeros(x.shape[:-1], x.dtype)

    def sample(self, key, shape=()):
        return self.mean + self.std * jax.random.normal(key, shape + (self.dim,))


class FlatDistribution(Target):
    """Improper flat density, log p == 0 (the 'flat' flow reference).

    Parity: reference ``FlatDistribution`` (/root/reference/distributions.py:100-111).
    """

    def __init__(self, dim: int = 1):
        self.dim = dim

    def log_lik(self, x):
        return jnp.zeros(x.shape[:-1], x.dtype)

    def log_prior(self, x):
        return jnp.zeros(x.shape[:-1], x.dtype)


class GaussianMixture(Target):
    """Mixture of diagonal-covariance Gaussians.

    Parity: reference ``GaussianMixture`` (/root/reference/distributions.py:42-77),
    including its convention that ``covs`` holds per-dimension *variances*
    (their cholesky is an elementwise sqrt, distributions.py:51).

    Batch-first design: ``log_prob`` of a (B, d) batch broadcasts against the
    (K, d) mode table, producing a (B, K) matrix reduced by ``logsumexp`` —
    one fused VPU pass, no per-component vmap, numerically stable in f32.
    """

    def __init__(
        self,
        modes: Optional[jax.Array] = None,
        covs: Optional[jax.Array] = None,
        weights: Optional[jax.Array] = None,
    ):
        if modes is None:  # reference default bimodal (distributions.py:43-47)
            modes = jnp.stack([5.0 * jnp.ones(2), jnp.zeros(2)])
            covs = 0.5 * jnp.ones((2, 2))
            weights = jnp.array([0.7, 0.3])
        modes = jnp.asarray(modes)
        covs = jnp.asarray(covs)
        if covs.ndim == 3:  # accept (K, d, d) diagonal matrices for convenience
            covs = jax.vmap(jnp.diag)(covs)
        self.dim = modes.shape[-1]
        self.modes = modes
        self.covs = covs  # per-dim variances, shape (K, d)
        self.chol_covs = jnp.sqrt(covs)  # per-dim std devs
        self.weights = jnp.asarray(weights)
        self.log_weights = jnp.log(self.weights)
        # per-component log normalizer: -1/2 sum_d log(2 pi var_kd)
        self._log_norm = -0.5 * jnp.sum(_LOG2PI + jnp.log(covs), axis=-1)  # (K,)

    @property
    def n_modes(self) -> int:
        return self.modes.shape[0]

    def log_lik(self, x):
        # x: (..., d) vs modes (K, d) -> (..., K)
        z = (x[..., None, :] - self.modes) / self.chol_covs
        comp = -0.5 * jnp.sum(z * z, axis=-1) + self._log_norm + self.log_weights
        return jax.scipy.special.logsumexp(comp, axis=-1)

    def log_prior(self, x):
        return jnp.zeros(x.shape[:-1], x.dtype)

    def sample(self, key, shape=()):
        """Ancestral sampler (reference distributions.py:73-77), batched."""
        key_choice, key_noise = jax.random.split(key)
        idx = jax.random.choice(key_choice, self.n_modes, shape, p=self.weights)
        eps = jax.random.normal(key_noise, shape + (self.dim,))
        return self.modes[idx] + self.chol_covs[idx] * eps

    def init_positions(self, key, n_chain):
        """N(0, I) chain init (reference distributions.py:69-71)."""
        return jax.random.normal(key, (n_chain, self.dim))


def four_mode_mixture() -> GaussianMixture:
    """The README '4-mode' benchmark target (reference multi_modal.py:79-85)."""
    modes = 8.0 * jnp.array([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]])
    covs = jnp.ones((4, 2))
    weights = jnp.ones(4) / 4.0
    return GaussianMixture(modes, covs, weights)


def random_mixture(
    key: Optional[jax.Array] = None,
    n_modes: int = 16,
    dim: int = 2,
    lim: float = 16.0,
) -> GaussianMixture:
    """The 'gaussian-mixture' benchmark: 16 random modes in a box
    (reference multi_modal.py:39-47, seeded with PRNGKey(0))."""
    if key is None:
        key = jax.random.PRNGKey(0)
    key_mode, key_cov, key_weight = jax.random.split(key, 3)
    modes = jax.random.uniform(
        key_mode, (n_modes, dim), minval=-lim * 0.8, maxval=lim * 0.8
    )
    covs = jnp.exp(0.5 * jax.random.normal(key_cov, (n_modes, dim)))
    weights = jax.random.dirichlet(key_weight, 4.0 * jnp.ones(n_modes))
    return GaussianMixture(modes, covs, weights)
