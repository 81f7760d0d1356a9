"""In-repo DDS: exact discrete-time invariances + training.

Reference behavior: exe_others.py:247-299 (external ``dds`` package, OU
reference process + cos^2 schedule + IS weights); drivers/dds.py is the
in-repo implementation, whose discrete-time construction makes two
properties EXACT (not discretization-limited) — tested here.
"""

import jax
import jax.numpy as jnp
import pytest

from mfm_tpu.drivers.dds import cos_sq_betas, dds_baseline, run_dds
from mfm_tpu.targets import IndepGaussian, four_mode_mixture


def test_cos_sq_schedule_shape():
    b = cos_sq_betas(50, beta_min=1e-3, beta_max=0.3)
    assert b.shape == (50,)
    assert float(b[0]) == pytest.approx(0.3)  # coarse at the noise end
    assert float(b[-1]) == pytest.approx(1e-3)  # fine at the target end
    assert bool(jnp.all(b[:-1] >= b[1:]))  # monotone decreasing


def test_init_weights_telescope_to_terminal_ratio():
    """At init the control is zero (zero-init heads), so the path terms
    must telescope by OU detailed balance: log w == log pi(x_K) -
    log N(x_K; 0, sigma^2) exactly. Verified against an independent
    evaluation of the terminal ratio on the same chain."""
    target = four_mode_mixture()
    res = run_dds(target, seed=0, n_iter=1, batch_size=64, n_steps=30,
                  sigma=2.0, learning_rate=0.0)
    x, log_w = res.sample_fn(res.params, jax.random.PRNGKey(3), 64)
    d = target.dim
    ref_logpdf = (-0.5 * jnp.sum(x * x, -1) / 4.0
                  - 0.5 * d * jnp.log(2 * jnp.pi) - d * jnp.log(2.0))
    expected = target.log_prob(x) - ref_logpdf
    assert jnp.abs(log_w - expected).max() < 5e-3


def test_zero_weights_when_target_is_stationary():
    """Target == N(0, sigma^2 I) with zero control: the terminal ratio
    vanishes too, so log w == 0 for every trajectory. (Only exact while
    the control is zero — training on finite batches perturbs the
    zero-init heads even at the KL optimum, so freeze with lr=0.)"""
    target = IndepGaussian(4, var=1.0)
    res = run_dds(target, seed=0, n_iter=2, batch_size=32, n_steps=20,
                  sigma=1.0, learning_rate=0.0)
    _, log_w = res.sample_fn(res.params, jax.random.PRNGKey(1), 32)
    assert jnp.abs(log_w).max() < 5e-3


@pytest.mark.slow
def test_dds_trains_toward_4mode():
    target = four_mode_mixture()
    # hard target (modes 8 sigma out, log pi(origin) = -66): the detached
    # score + EMA gradient-spike skip keep this stable at 2e-3 and beyond.
    # The 300-iteration trajectory is chaotic in the low-order float bits,
    # so the final ESS is platform-dependent: ~0.21 on the 8-virtual-device
    # CPU mesh (measured; untrained level is 0.004), higher on an
    # accelerator. The threshold sits well above untrained and below both.
    res = run_dds(target, seed=0, n_iter=300, batch_size=128, n_steps=50,
                  sigma=4.0, learning_rate=2e-3, hidden=(64, 64))
    assert jnp.isfinite(res.losses).all()
    # the KL estimate (= -mean log w) must drop toward -logZ; equivalently
    # the IS ESS must rise well above the untrained-prior level
    x, log_w = res.sample_fn(res.params, jax.random.PRNGKey(7), 512)
    lse = jax.scipy.special.logsumexp
    ess = float(jnp.exp(2 * lse(log_w) - lse(2 * log_w))) / 512
    assert ess > 0.1, ess
    # and the trained logZ estimate is near the truth (4-mode: logZ = 0)
    log_z = float(lse(log_w) - jnp.log(512))
    assert abs(log_z) < 0.25, log_z


@pytest.mark.slow
def test_dds_baseline_adapter_schema():
    from mfm_tpu.config import preset

    cfg = preset("4-mode", learning_iter=20, num_chain=64, eval_iter=2)
    target = four_mode_mixture()
    result = dds_baseline(target, cfg, seed=0)
    n_eval = cfg.eval_iter * cfg.num_chain
    assert result.flow_samples.shape == (n_eval, 2)
    assert result.exact_samples.shape == (n_eval, 2)
    assert result.train_time > 0
    assert jnp.isfinite(result.extras["log_z_is"])
