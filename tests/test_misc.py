"""Coverage for remaining utilities: pytree helpers, eval aggregation,
flow progression, waste-free SMC, window adaptation with NUTS, resampler
choices inside SMC."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfm_tpu.utils import gaussian_like, linear_map, pytree_size, ravel_batch


class TestUtils:
    def test_gaussian_like_structure(self, key):
        tree = {"a": jnp.zeros((3, 2)), "b": (jnp.zeros(5),)}
        noise = gaussian_like(key, tree, mu=1.0, sigma=0.0)
        np.testing.assert_allclose(np.asarray(noise["a"]), 1.0)
        assert noise["b"][0].shape == (5,)

    def test_linear_map_dispatch(self):
        v = jnp.array([1.0, 2.0])
        np.testing.assert_allclose(
            np.asarray(linear_map(jnp.array([2.0, 3.0]), v)), [2.0, 6.0]
        )
        A = jnp.array([[0.0, 1.0], [1.0, 0.0]])
        np.testing.assert_allclose(np.asarray(linear_map(A, v)), [2.0, 1.0])

    def test_pytree_size_and_ravel_batch(self):
        tree = {"a": jnp.zeros((4, 3)), "b": jnp.zeros((4, 2, 2))}
        assert pytree_size(tree) == 12 + 16
        flat, unravel = ravel_batch(tree)
        assert flat.shape == (4, 7)
        back = unravel(flat)
        assert back["b"].shape == (4, 2, 2)


class TestEvalHelpers:
    def test_report_row_and_aggregate(self):
        from mfm_tpu.config import MFMConfig
        from mfm_tpu.drivers import aggregate_seeds, report_row

        cfg = MFMConfig()
        metrics = {
            "logpdf": -1.0, "logpdf_star": -0.5, "stein_u": 0.1,
            "stein_u_star": 0.05, "stein_v": 0.2, "stein_v_star": 0.1,
            "mmd": 0.01, "mmd_star": 0.005,
        }
        row = report_row(cfg, metrics, 1.5)
        assert len(row) == 11
        agg = aggregate_seeds([row, row])
        np.testing.assert_allclose(agg["ci95"], 0.0, atol=1e-12)


class TestFlowProgression:
    @pytest.mark.slow
    def test_progression_figure(self, key):
        from mfm_tpu.drivers.plots import flow_progression
        from mfm_tpu.flows import make_transport, make_vector_field

        apply_fn, params = make_vector_field(
            key, 2, hidden_x=(8,), hidden_t=(8,), hidden_xt=(8,), fourier_dim=4
        )
        transport = make_transport(apply_fn, n_steps=8)
        u = jax.random.normal(key, (32, 2))
        fig = flow_progression(transport, params, u)
        assert fig is not None


class TestWasteFreeHook:
    def test_num_resampled_smaller(self, key):
        """Waste-free hook: resample M < N ancestors; the update returns N."""
        from mfm_tpu.smc import base as smc_base
        from mfm_tpu.smc import systematic

        n, m = 64, 16
        particles = jax.random.normal(key, (n, 2))
        state = smc_base.init(particles)

        def update_fn(k, p):  # expand M resampled particles back to N
            reps = n // m
            return jnp.repeat(p, reps, axis=0) + 0.01, None

        new_state, info = smc_base.step(
            key, state, update_fn, lambda p: jnp.zeros(p.shape[0]),
            systematic, num_resampled=m,
        )
        assert new_state.particles.shape == (n, 2)
        assert info.ancestors.shape == (m,)

    @pytest.mark.parametrize("name", ["stratified", "residual"])
    def test_smc_with_other_resamplers(self, name, key):
        from mfm_tpu.drivers import run_smc
        from mfm_tpu.config import MFMConfig
        from mfm_tpu.targets import IndepGaussian

        cfg = MFMConfig(dim=2, num_chain=64, learning_iter=8, eval_iter=2,
                        step_size=0.3, anneal_iter=10, num_anneal_temp=5)
        result = run_smc(IndepGaussian(2, mean=1.0), cfg, resampler=name)
        assert np.isfinite(np.asarray(result.particles)).all()


class TestWindowAdaptationNUTS:
    @pytest.mark.slow
    def test_nuts_window(self, key):
        from mfm_tpu.adaptation.window import window_adaptation
        from mfm_tpu.kernels import mala, nuts
        from mfm_tpu.targets import IndepGaussian

        target = IndepGaussian(2, var=4.0)
        vs = lambda x: target.value_and_score(x)
        nuts_kernel = nuts.build_kernel(vs, max_depth=4)

        adapt = window_adaptation(
            lambda k, s, step, im: nuts_kernel(k, s, step, im),
            lambda pos: mala.init(pos, vs),
            num_steps=200,
            initial_step_size=0.05,
        )
        state, (step_size, inv_mass), acc = adapt.run(
            key, 2.0 * jax.random.normal(key, (64, 2))
        )
        assert float(step_size) > 0.0
        assert np.isfinite(np.asarray(inv_mass)).all()
        assert 1.0 < float(np.asarray(inv_mass).mean()) < 8.0  # toward var=4


class TestWeightedEval:
    def test_log_weights_add_weighted_stein(self, key):
        from mfm_tpu.drivers import evaluate_samples
        from mfm_tpu.targets import IndepGaussian

        target = IndepGaussian(2)
        xs = target.sample(key, (128,))
        lw = jnp.zeros(128)
        m = evaluate_samples(target, xs, xs, log_weights=lw)
        # uniform weights -> weighted == unweighted
        np.testing.assert_allclose(m["stein_u_weighted"], m["stein_u"], rtol=1e-4)


class TestImportPurity:
    """Importing the library must not initialize any JAX backend.

    A module-level jnp constant anywhere in mfm_tpu initializes whatever
    platform the environment presets before user code can choose one
    (this regressed once via a jnp Butcher tableau in flows/ode.py)."""

    @pytest.mark.slow
    def test_import_initializes_no_backend(self):
        import subprocess
        import sys

        env = dict(os.environ, JAX_PLATFORMS="bogus")
        r = subprocess.run(
            [sys.executable, "-c",
             "import mfm_tpu.cli, mfm_tpu.drivers, mfm_tpu.flows.ode; print('PURE')"],
            capture_output=True, text=True, timeout=240, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        assert r.returncode == 0, r.stderr
        assert "PURE" in r.stdout
        # backend init under JAX_PLATFORMS=bogus raises/warns; neither may
        # happen during a plain library import
        assert "Unknown backend" not in r.stderr
        assert "experimental" not in r.stderr
