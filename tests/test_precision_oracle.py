"""f32 vs float64-oracle tolerance checks (SURVEY.md section 7 hard part (a)).

The reference runs everything in x64 (multi_modal.py:14); accelerators are
f32-first.
These tests pin the f32 implementations against the same computation run
under the x64 context on CPU: MALA acceptance probabilities, CNF logdets,
and the LGCP density must agree to tolerances that keep MH decisions and IS
weights statistically faithful.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfm_tpu.flows import make_transport, make_vector_field
from mfm_tpu.kernels import mala
from mfm_tpu.targets import LogGaussianCoxPines, four_mode_mixture


class TestPrecisionOracle:
    def test_mala_acceptance_f32_vs_f64(self, key):
        """Same (current, proposal) pairs: the acceptance probability itself
        must agree across precisions (the PRNG stream differs by dtype, so
        the comparison fixes the proposals)."""
        from mfm_tpu.kernels.mala import _transition_energy

        target = four_mode_mixture()
        h = 0.2
        x = jax.random.normal(key, (64, 2)) * 3
        noise = jax.random.normal(jax.random.fold_in(key, 1), (64, 2))

        def acceptance(xv, noisev, tgt):
            ld, g = tgt.value_and_score(xv)
            prop = xv + h * g + jnp.sqrt(2.0 * h) * noisev
            pld, pg = tgt.value_and_score(prop)
            fwd = _transition_energy(ld, xv, g, prop, h)
            bwd = _transition_energy(pld, prop, pg, xv, h)
            return jnp.clip(jnp.exp(fwd - bwd), max=1.0)

        acc32 = np.asarray(acceptance(x, noise, target))
        with jax.enable_x64(True):
            t64 = four_mode_mixture()
            x64 = jnp.asarray(np.asarray(x), jnp.float64)
            n64 = jnp.asarray(np.asarray(noise), jnp.float64)
            acc64 = np.asarray(acceptance(x64, n64, t64))

        np.testing.assert_allclose(acc32, acc64, atol=2e-4)

    @pytest.mark.slow
    def test_cnf_logdet_f32_vs_f64(self, key):
        target = four_mode_mixture()
        apply_fn, params = make_vector_field(
            key, 2, score_fn=target.score, hidden_x=(16,), hidden_t=(16,),
            hidden_xt=(16,), fourier_dim=8,
        )
        params = jax.tree_util.tree_map(lambda p: p + 0.05, params)
        transport = make_transport(apply_fn, divergence="exact", n_steps=16)
        u32 = jax.random.normal(key, (16, 2))
        x32, ld32 = transport.forward(params, u32)

        with jax.enable_x64(True):
            # same network (f32 Fourier-frequency constants promote), same
            # weights promoted to f64
            params64 = jax.tree_util.tree_map(
                lambda p: jnp.asarray(np.asarray(p), jnp.float64), params
            )
            transport64 = make_transport(apply_fn, divergence="exact", n_steps=16)
            u64 = jnp.asarray(np.asarray(u32), jnp.float64)
            x64, ld64 = transport64.forward(params64, u64)
            x64 = np.asarray(x64)
            ld64 = np.asarray(ld64)

        np.testing.assert_allclose(np.asarray(x32), x64, atol=2e-5)
        np.testing.assert_allclose(np.asarray(ld32), ld64, atol=5e-5)

    def test_lgcp_density_f32_vs_f64_construction(self, key):
        """The f32 LGCP (with float64 host-side Gram/Cholesky) must match an
        all-f64 evaluation to IS-weight-safe tolerance."""
        lg32 = LogGaussianCoxPines(dim=64)
        x = lg32.init_positions(key, 4)
        v32 = np.asarray(lg32.log_prob(x))

        with jax.enable_x64(True):
            lg64 = LogGaussianCoxPines(dim=64, dtype=jnp.float64)
            x64 = jnp.asarray(np.asarray(x), jnp.float64)
            v64 = np.asarray(lg64.log_prob(x64))

        np.testing.assert_allclose(v32, v64, rtol=2e-5)
