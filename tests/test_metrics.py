"""Diagnostics: Stein discrepancy, MMD, autocorrelation, ESS."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfm_tpu.diagnostics import (
    autocorrelation,
    effective_sample_size,
    max_mean_disc,
    stein_disc,
)
from mfm_tpu.targets import IndepGaussian, four_mode_mixture


def _naive_stein(X, score_fn, beta=-0.5):
    """Elementwise reference implementation of the IMQ-Stein sums."""
    X = np.asarray(X, np.float64)
    S = np.asarray(score_fn(jnp.asarray(X, jnp.float32)), np.float64)
    T, d = X.shape
    b = -beta
    total = 0.0
    for i in range(T):
        for j in range(T):
            diff = X[i] - X[j]
            r = diff @ diff
            total += (
                -4 * b * (b + 1) * r / (1 + r) ** (b + 2)
                + 2 * b * (d + (S[i] - S[j]) @ diff) / (1 + r) ** (1 + b)
                + S[i] @ S[j] / (1 + r) ** b
            )
    diag = sum(2 * b * d + S[i] @ S[i] for i in range(T))
    return (total - diag) / (T * (T - 1)), total / T**2


def _neg(x):
    return -x


def _naive_mmd(X, Y, sigma2=1.0):
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    m = X.shape[0]

    def ks(A, B):
        d = ((A[:, None] - B[None]) ** 2).sum(-1)
        return np.exp(-0.5 * d / sigma2).sum()

    return (
        (ks(X, X) - m) / (m * m - m)
        - 2 * ks(X, Y) / (m * m)
        + (ks(Y, Y) - m) / (m * m - m)
    )


class TestStein:
    def test_matches_naive(self, key):
        target = four_mode_mixture()
        X = jax.random.normal(key, (37, 2)) * 3  # non-multiple of tile
        u, v = stein_disc(X, target.score, tile=16)
        u_ref, v_ref = _naive_stein(X, target.score)
        np.testing.assert_allclose(u, u_ref, rtol=1e-3)
        np.testing.assert_allclose(v, v_ref, rtol=1e-3)

    # T is never a multiple of the tile; at d=64 the Gram GEMMs carry the sums
    @pytest.mark.parametrize("d, T", [(2, 70), (3, 45), (64, 70)])
    def test_matches_naive_across_widths(self, key, d, T):
        X = 2.0 * jax.random.normal(jax.random.fold_in(key, d), (T, d))
        u, v = stein_disc(X, _neg, tile=32)
        u_ref, v_ref = _naive_stein(X, _neg)
        np.testing.assert_allclose(u, u_ref, rtol=1e-3)
        np.testing.assert_allclose(v, v_ref, rtol=1e-3)

    def test_exact_samples_small(self, key):
        """KSD of exact target samples should be near zero; of wrong samples
        should be clearly larger."""
        target = IndepGaussian(2)
        good = target.sample(key, (512,))
        bad = 3.0 + 2.0 * target.sample(jax.random.fold_in(key, 1), (512,))
        u_good, _ = stein_disc(good, target.score)
        u_bad, _ = stein_disc(bad, target.score)
        assert abs(float(u_good)) < 0.05
        assert float(u_bad) > 10 * abs(float(u_good))


class TestMMD:
    def test_matches_naive(self, key):
        X = jax.random.normal(key, (41, 3))
        Y = jax.random.normal(jax.random.fold_in(key, 1), (41, 3)) + 0.5
        got = max_mean_disc(X, Y, tile=16)
        np.testing.assert_allclose(got, _naive_mmd(X, Y), rtol=1e-3, atol=1e-5)

    @pytest.mark.parametrize("d, T", [(3, 50), (64, 45)])
    def test_matches_naive_across_widths(self, key, d, T):
        scale = 1.5 / np.sqrt(d)  # pairwise distances of order one at every d
        X = scale * jax.random.normal(key, (T, d))
        Y = scale * (0.3 + jax.random.normal(jax.random.fold_in(key, 1), (T, d)))
        got = max_mean_disc(X, Y, sigma2=2.0, tile=16)
        np.testing.assert_allclose(
            got, _naive_mmd(X, Y, sigma2=2.0), rtol=1e-3, atol=1e-5
        )

    def test_identical_distributions_near_zero(self, key):
        X = jax.random.normal(key, (400, 2))
        Y = jax.random.normal(jax.random.fold_in(key, 1), (400, 2))
        assert abs(float(max_mean_disc(X, Y))) < 0.01

    def test_separated_distributions_positive(self, key):
        X = jax.random.normal(key, (200, 2))
        Y = X + 5.0
        assert float(max_mean_disc(X, Y)) > 0.5


class TestAutocorr:
    def test_iid_decorrelated(self, key):
        x = np.asarray(jax.random.normal(key, (4096,)))
        ac = autocorrelation(x)
        assert ac[0] == 1.0
        assert np.abs(ac[1:50]).max() < 0.1

    def test_ar1_matches_theory(self, key):
        rho = 0.9
        eps = np.asarray(jax.random.normal(key, (20000,)))
        x = np.zeros_like(eps)
        for t in range(1, len(eps)):
            x[t] = rho * x[t - 1] + eps[t]
        ac = autocorrelation(x)
        np.testing.assert_allclose(ac[1], rho, atol=0.03)
        np.testing.assert_allclose(ac[5], rho**5, atol=0.05)

    def test_ess_iid_vs_correlated(self, key):
        iid = np.asarray(jax.random.normal(key, (4000, 1)))
        ess_iid = effective_sample_size(iid)[0]
        assert ess_iid > 2500
        rho = 0.95
        eps = np.asarray(jax.random.normal(key, (4000,)))
        x = np.zeros_like(eps)
        for t in range(1, len(eps)):
            x[t] = rho * x[t - 1] + eps[t]
        ess_corr = effective_sample_size(x[:, None])[0]
        # theory: ESS ~= N (1-rho)/(1+rho) ~= N/39
        assert ess_corr < 500


class TestRhat:
    def test_converged_chains_near_one(self, key):
        from mfm_tpu.diagnostics import potential_scale_reduction

        x = np.asarray(jax.random.normal(key, (500, 8, 2)))
        rhat = potential_scale_reduction(x)
        np.testing.assert_allclose(rhat, 1.0, atol=0.05)

    def test_disjoint_chains_flagged(self, key):
        from mfm_tpu.diagnostics import potential_scale_reduction

        x = np.array(jax.random.normal(key, (500, 4, 1)))
        x[:, :2] += 10.0  # two chains stuck elsewhere
        rhat = potential_scale_reduction(x)
        assert rhat[0] > 2.0


class TestWeightedStein:
    def test_uniform_weights_match_unweighted(self, key):
        from mfm_tpu.targets import four_mode_mixture

        target = four_mode_mixture()
        X = jax.random.normal(key, (50, 2)) * 3
        u0, v0 = stein_disc(X, target.score, tile=16)
        u1, v1 = stein_disc(X, target.score, tile=16, weights=jnp.ones(50))
        np.testing.assert_allclose(float(u1), float(u0), rtol=1e-4)
        np.testing.assert_allclose(float(v1), float(v0), rtol=1e-4)

    def test_weights_equal_duplication(self, key):
        """V-stat with counts-as-weights == V-stat of the duplicated set."""
        from mfm_tpu.targets import IndepGaussian

        target = IndepGaussian(2)
        X = jax.random.normal(key, (20, 2))
        counts = np.asarray(jax.random.randint(key, (20,), 1, 4))
        X_dup = jnp.repeat(X, jnp.asarray(counts), axis=0)
        _, v_dup = stein_disc(X_dup, target.score, tile=16)
        _, v_w = stein_disc(
            X, target.score, tile=16, weights=jnp.asarray(counts, jnp.float32)
        )
        np.testing.assert_allclose(float(v_w), float(v_dup), rtol=1e-4)
