"""Sample-quality diagnostics: kernelized Stein discrepancy, MMD,
autocorrelation, effective sample size.

Parity with the reference diagnostics (/root/reference/mcmc_utils.py:28-165),
redesigned as GEMMs:

The reference evaluates the O(T^2) pairwise sums elementwise under nested
vmaps row-chunked by ``lax.map`` (mcmc_utils.py:77-85). Here every pairwise
quantity is decomposed into **Gram matrices** computed as (tile, d) @ (d, T)
GEMMs —

    ||x - y||^2        = ||x||^2 + ||y||^2 - 2 x.y
    (sx - sy).(x - y)  = sx.x - sx.y - sy.x + sy.y
    sx.sy              = one score Gram

— so the hot loop is five matmuls per row tile plus fused elementwise math,
and memory stays bounded at tile x T.
"""

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_HIGH = lax.Precision.HIGHEST


def _pad_rows(x: jax.Array, tile: int):
    T = x.shape[0]
    pad = (-T) % tile
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
    return x, T, pad


@partial(jax.jit, static_argnames=("score_fn", "beta", "tile"))
def stein_disc(
    X: jax.Array,
    score_fn: Callable,
    beta: float = -0.5,
    tile: int = 128,
    weights=None,
) -> Tuple[jax.Array, jax.Array]:
    """Kernelized Stein discrepancy with the IMQ kernel (1 + ||x-y||^2)^beta.

    Returns (U-statistic, V-statistic) like the reference
    (mcmc_utils.py:28-85). ``score_fn`` is the batched target score
    (B, d) -> (B, d). Uses the same closed-form combined expression with
    b = -beta:

        -4 b (b+1) r / (1+r)^(b+2)
        + 2 b (d + (sx - sy).(x-y)) / (1+r)^(b+1)
        + sx.sy / (1+r)^b,          r = ||x - y||^2

    ``weights`` (optional, (T,), normalized internally): importance-weighted
    statistics sum w_i w_j k0(x_i, x_j) — evaluates IS-corrected sample sets
    without the duplication inflation of resampling (new capability; the
    reference only supports uniform weights).
    """
    T, d = X.shape
    b = -beta
    S = score_fn(X)  # (T, d)
    sq = jnp.sum(X * X, axis=-1)  # (T,)
    sx_dot_x = jnp.sum(S * X, axis=-1)  # (T,)
    if weights is None:
        w = jnp.full((T,), 1.0 / T)
    else:
        w = weights / jnp.sum(weights)

    Xp, _, pad = _pad_rows(X, tile)
    Sp, _, _ = _pad_rows(S, tile)
    sqp, _, _ = _pad_rows(sq, tile)
    sxxp, _, _ = _pad_rows(sx_dot_x, tile)
    wp, _, _ = _pad_rows(w, tile)
    n_tiles = Xp.shape[0] // tile

    def row_tile(i):
        xi = lax.dynamic_slice_in_dim(Xp, i * tile, tile)  # (t, d)
        si = lax.dynamic_slice_in_dim(Sp, i * tile, tile)
        sqi = lax.dynamic_slice_in_dim(sqp, i * tile, tile)
        sxxi = lax.dynamic_slice_in_dim(sxxp, i * tile, tile)
        wi = lax.dynamic_slice_in_dim(wp, i * tile, tile)

        xy = jnp.dot(xi, X.T, precision=_HIGH)  # (t, T)
        sxy = jnp.dot(si, X.T, precision=_HIGH)  # sx . y
        syx = jnp.dot(xi, S.T, precision=_HIGH)  # sy . x
        ss = jnp.dot(si, S.T, precision=_HIGH)  # sx . sy

        r = sqi[:, None] + sq[None, :] - 2.0 * xy
        r = jnp.maximum(r, 0.0)
        base = 1.0 + r
        cross = sxxi[:, None] - sxy - syx + sx_dot_x[None, :]
        term = (
            -4.0 * b * (b + 1.0) * r / base ** (b + 2.0)
            + 2.0 * b * (d + cross) / base ** (b + 1.0)
            + ss / base**b
        )
        # padded rows have w = 0, so weighting also masks them
        return jnp.sum(wi[:, None] * w[None, :] * term)

    total = jnp.sum(lax.map(row_tile, jnp.arange(n_tiles)))
    # diagonal: r = 0, cross = 0 -> 2 b d + ||sx||^2
    diag_terms = 2.0 * b * d + jnp.sum(S * S, axis=-1)
    w2 = jnp.sum(w * w)
    u_stat = (total - jnp.sum(w * w * diag_terms)) / (1.0 - w2)
    v_stat = total
    return u_stat, v_stat


@partial(jax.jit, static_argnames=("sigma2", "tile"))
def max_mean_disc(
    X: jax.Array, Y: jax.Array, sigma2: float = 1.0, tile: int = 256
) -> jax.Array:
    """MMD^2 with RBF kernel exp(-||x-y||^2 / (2 sigma2)); unbiased
    diagonal-removed XX/YY estimator (reference mcmc_utils.py:88-111).

    The reference assumes len(X) == len(Y) == m and normalizes all three
    sums by m; behavior is matched for that case.
    """
    m = X.shape[0]

    def ksum(A, B):
        sqa = jnp.sum(A * A, axis=-1)
        sqb = jnp.sum(B * B, axis=-1)
        Ap, Ta, _ = _pad_rows(A, tile)
        sqap, _, _ = _pad_rows(sqa, tile)
        n_tiles = Ap.shape[0] // tile
        valid = jnp.arange(Ap.shape[0]) < Ta

        def row_tile(i):
            ai = lax.dynamic_slice_in_dim(Ap, i * tile, tile)
            sqi = lax.dynamic_slice_in_dim(sqap, i * tile, tile)
            vi = lax.dynamic_slice_in_dim(valid, i * tile, tile)
            ab = jnp.dot(ai, B.T, precision=_HIGH)
            r = jnp.maximum(sqi[:, None] + sqb[None, :] - 2.0 * ab, 0.0)
            k = jnp.exp(-0.5 * r / sigma2)
            return jnp.sum(jnp.where(vi[:, None], k, 0.0))

        return jnp.sum(lax.map(row_tile, jnp.arange(n_tiles)))

    xx = ksum(X, X) - m  # remove k(x,x) = 1 diagonal
    yy = ksum(Y, Y) - Y.shape[0]
    xy = ksum(X, Y)
    m2 = m * m
    return xx / (m2 - m) - 2.0 * xy / m2 + yy / (m2 - m)


def _next_fast_len(n: int) -> int:
    """Smallest 5-smooth integer >= n (reference mcmc_utils.py:114-129)."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def autocorrelation(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """FFT-based autocorrelation along ``axis`` (host-side numpy; reference
    mcmc_utils.py:131-165, Stan-style normalization)."""
    x = np.asarray(x)
    N = x.shape[axis]
    M2 = 2 * _next_fast_len(N)
    x = np.swapaxes(x, axis, -1)
    centered = x - x.mean(axis=-1, keepdims=True)
    freq = np.fft.rfft(centered, n=M2, axis=-1)
    ac = np.fft.irfft(freq * np.conjugate(freq), n=M2, axis=-1)[..., :N]
    with np.errstate(invalid="ignore", divide="ignore"):
        ac = ac / ac[..., :1]
    return np.swapaxes(ac, axis, -1)


def potential_scale_reduction(chains: np.ndarray) -> np.ndarray:
    """Split-R-hat over a (n_steps, n_chains, d) sample block (Gelman et al.;
    new capability — the reference has no convergence diagnostic)."""
    x = np.asarray(chains)
    if x.ndim == 2:
        x = x[:, :, None]
    T = x.shape[0] - (x.shape[0] % 2)
    half = T // 2
    # split each chain in two
    x = np.concatenate([x[:half], x[half:T]], axis=1)  # (half, 2m, d)
    n, m, d = x.shape
    chain_means = x.mean(axis=0)  # (m, d)
    chain_vars = x.var(axis=0, ddof=1)  # (m, d)
    between = n * chain_means.var(axis=0, ddof=1)
    within = chain_vars.mean(axis=0)
    var_plus = (n - 1) / n * within + between / n
    return np.sqrt(var_plus / within)


def effective_sample_size(x: np.ndarray) -> np.ndarray:
    """Per-dimension ESS of a (T, d) chain via Geyer's initial positive
    sequence on FFT autocorrelations (new capability; the reference stops at
    raw autocorrelation)."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    T = x.shape[0]
    ac = autocorrelation(x, axis=0)  # (T, d)
    ess = np.empty(x.shape[1])
    for j in range(x.shape[1]):
        # pair consecutive lags; stop at first negative pair sum
        pair = ac[: (T // 2) * 2, j].reshape(-1, 2).sum(axis=1)
        neg = np.nonzero(pair < 0)[0]
        stop = neg[0] if neg.size else pair.size
        tau = -1.0 + 2.0 * pair[:stop].sum()
        ess[j] = T / max(tau, 1.0 / T)
    return ess
