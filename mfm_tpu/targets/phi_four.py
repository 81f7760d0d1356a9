"""1-D lattice phi^4 field theory target and its Gaussian base approximation.

Capability parity with the reference ``PhiFour`` / ``PhiFourBase``
(/root/reference/distributions.py:114-226). Batched redesign:

- The lattice energy is written as a fused batched stencil over a (B, d)
  field batch — one pad + one elementwise pass + row reductions — rather than
  per-sample evaluation under vmap.
- ``PhiFourBase``'s tridiagonal Gaussian uses a precomputed Cholesky factor;
  the batched log-density is a single (B, d) @ (d, d) matmul with
  HIGHEST precision (the quadratic form is the accuracy-critical piece in
  f32).
"""

from typing import Optional, Tuple

import math

import jax
import jax.numpy as jnp
from jax import lax

from mfm_tpu.targets.base import Target

_LOG2PI = math.log(2.0 * math.pi)


class PhiFour(Target):
    """phi^4 lattice: log p(x) = -beta * (U(x) + V(x)).

    ``V`` is the on-site double-well potential sum (1 - x^2)^2 / (4 a d)
    (reference distributions.py:131-139, plus optional mean tilt) and ``U``
    the a*d-weighted squared-gradient coupling with dirichlet or periodic
    boundary (reference distributions.py:141-151).
    """

    def __init__(
        self,
        dim: int,
        a: float = 0.1,
        beta: float = 20.0,
        bc: Tuple[str, float] = ("dirichlet", 0.0),
        tilt: Optional[dict] = None,
    ):
        assert bc[0] in ("dirichlet", "pbc"), "bc must be dirichlet or pbc"
        self.dim = dim
        self.a = a
        self.beta = beta
        self.bc = bc
        self.tilt = tilt
        self._coef = a * dim

    def _energy(self, x: jax.Array) -> jax.Array:
        """Batched U + V for (..., d) fields, reduced over the lattice axis."""
        # on-site potential V
        diffs = 1.0 - jnp.square(x)
        v = jnp.sum(diffs * diffs, axis=-1) / (4.0 * self._coef)
        if self.tilt is not None:
            t = (self.tilt["val"] - jnp.mean(x, axis=-1)) ** 2
            v = v + self.tilt["lambda"] * t / (4.0 * self.dim)
        # gradient coupling U via boundary-aware first differences
        if self.bc[0] == "dirichlet":
            pad = [(0, 0)] * (x.ndim - 1) + [(1, 1)]
            x_ = jnp.pad(x, pad, mode="constant", constant_values=self.bc[1])
        else:  # periodic: prepend the last site
            x_ = jnp.concatenate([x[..., -1:], x], axis=-1)
        d1 = x_[..., 1:] - x_[..., :-1]
        u = 0.5 * jnp.sum(d1 * d1, axis=-1) * self._coef
        return u + v

    def log_lik(self, x):
        return -self.beta * self._energy(x)

    def log_prior(self, x):
        return jnp.zeros(x.shape[:-1], x.dtype)

    def init_positions(self, key, n_chain):
        """Uniform(-1, 1) init (reference distributions.py:162-164)."""
        return jax.random.uniform(key, (n_chain, self.dim)) * 2.0 - 1.0


def _coupled_precision(dim: int, alpha: float, beta: float) -> jax.Array:
    """Tridiagonal precision of the coupled Gaussian approximation
    (reference distributions.py:180-185): beta * [(3c + 1/c) I - c (offdiag)]
    with c = alpha * dim."""
    c = alpha * dim
    main = (3.0 * c + 1.0 / c) * jnp.ones(dim)
    prec = jnp.diag(main)
    off = -c * jnp.ones(dim - 1)
    prec = prec + jnp.diag(off, k=1) + jnp.diag(off, k=-1)
    return beta * prec


def _coupled_pbc_precision(dim: int, dim_phys: int, beta: float) -> jax.Array:
    """Periodic-boundary variant (reference distributions.py:187-209; note the
    reference's in-place numpy mutations on jnp arrays make its pbc branch
    dead code — this is the working functional equivalent)."""
    dim_grid = dim // dim_phys
    eps = 0.1
    quad = 4.0 + eps
    sub = (1.0 + quad) * jnp.eye(dim_grid)
    off = -jnp.ones(dim_grid - 1)
    sub = sub + jnp.diag(off, k=1) + jnp.diag(off, k=-1)
    sub = sub.at[0, -1].set(-1.0).at[-1, 0].set(-1.0)
    if dim_phys == 1:
        return beta * sub
    # 2-D grid: couple along the second axis with -I blocks, pbc wrap
    prec = jax.scipy.linalg.block_diag(*([sub] * dim_grid))
    eye_g = jnp.eye(dim_grid)
    for b in range(dim_grid - 1):
        s0, s1 = b * dim_grid, (b + 1) * dim_grid
        prec = prec.at[s0 : s0 + dim_grid, s1 : s1 + dim_grid].add(-eye_g)
        prec = prec.at[s1 : s1 + dim_grid, s0 : s0 + dim_grid].add(-eye_g)
    prec = prec.at[:dim_grid, -dim_grid:].set(-eye_g)
    prec = prec.at[-dim_grid:, :dim_grid].set(-eye_g)
    return beta * prec


class PhiFourBase(Target):
    """Gaussian approximation of the phi^4 prior, the 'phifour' flow reference
    distribution (reference distributions.py:168-226)."""

    def __init__(
        self,
        dim: int,
        alpha: float = 0.1,
        beta: float = 20.0,
        prior_type: str = "coupled",
        dim_phys: int = 1,
    ):
        self.dim = dim
        if prior_type == "coupled":
            prec = _coupled_precision(dim, alpha, beta)
        elif prior_type == "coupled_pbc":
            prec = _coupled_pbc_precision(dim, dim_phys, beta)
        else:
            raise ValueError(f"unknown prior_type {prior_type!r}")
        self.prec = prec
        sign, logabsdet = jnp.linalg.slogdet(prec)
        self._neg_logdet_prec = -sign * logabsdet
        chol = jax.scipy.linalg.cholesky(prec, lower=True)
        # covariance cholesky (upper-tri transpose of inv(chol)), used for sampling
        self.chol_cov = jax.scipy.linalg.solve_triangular(
            chol, jnp.eye(dim), lower=True
        ).T

    def log_lik(self, x):
        quad = jnp.einsum(
            "...i,ij,...j->...", x, self.prec, x, precision=lax.Precision.HIGHEST
        )
        return -0.5 * (quad + self.dim * _LOG2PI + self._neg_logdet_prec)

    def log_prior(self, x):
        return jnp.zeros(x.shape[:-1], x.dtype)

    def sample(self, key, shape=()):
        eps = jax.random.normal(key, shape + (self.dim,))
        return jnp.einsum(
            "ij,...j->...i", self.chol_cov, eps, precision=lax.Precision.HIGHEST
        )
