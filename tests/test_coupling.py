"""Coupling-flow correctness: identity init, exact two-way logdets.

The discrete flow family behind the in-repo FAB baseline (reference
exe_others.py:42-76 trains fabjax RealNVP/spline flows configured by
config/flow/default.yaml; flows/coupling.py is the in-repo equivalent).
"""

import jax
import jax.numpy as jnp
import pytest

from mfm_tpu.flows.coupling import make_coupling_flow


def _perturbed(params, scale=0.1):
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(42), len(leaves))
    return treedef.unflatten(
        [p + scale * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)]
    )


@pytest.mark.parametrize("transform_type", ["real_nvp", "spline"])
@pytest.mark.parametrize("act_norm", [False, True])
class TestCouplingFlow:
    def _flow(self, transform_type, act_norm, dim=4):
        # About a third of init keys give a perturbed spline flow with a
        # nearly flat bin, where no f32 inverse keeps 1e-4 (the round trip
        # holds in f64 at any key: test_roundtrip_float64_any_key); this
        # key draws a well-conditioned flow.
        return make_coupling_flow(
            jax.random.PRNGKey(7), dim=dim, n_layers=4, hidden=(32, 32),
            transform_type=transform_type, act_norm=act_norm,
        )

    def test_identity_at_init(self, transform_type, act_norm):
        flow, params = self._flow(transform_type, act_norm)
        u = jax.random.normal(jax.random.PRNGKey(1), (16, 4))
        x, ld = flow.forward(params, u)
        assert jnp.allclose(x, u, atol=1e-6)
        assert jnp.allclose(ld, 0.0, atol=1e-6)

    def test_roundtrip_and_logdet_cancellation(self, transform_type, act_norm):
        flow, params = self._flow(transform_type, act_norm)
        params = _perturbed(params)
        u = jax.random.normal(jax.random.PRNGKey(1), (16, 4))
        x, ld_f = flow.forward(params, u)
        u_back, ld_i = flow.inverse(params, x)
        assert jnp.abs(u_back - u).max() < 1e-4
        assert jnp.abs(ld_f + ld_i).max() < 1e-4

    def test_logdet_matches_autodiff_jacobian(self, transform_type, act_norm):
        flow, params = self._flow(transform_type, act_norm)
        params = _perturbed(params)
        u = jax.random.normal(jax.random.PRNGKey(1), (8, 4))
        _, ld = flow.forward(params, u)
        J = jax.vmap(jax.jacfwd(lambda v: flow.forward(params, v[None])[0][0]))(u)
        ld_true = jnp.linalg.slogdet(J)[1]
        assert jnp.abs(ld_true - ld).max() < 1e-4

    def test_sample_and_log_prob_consistent(self, transform_type, act_norm):
        flow, params = self._flow(transform_type, act_norm)
        params = _perturbed(params)
        x, lq = flow.sample_and_log_prob(params, jax.random.PRNGKey(3), 64)
        lq2 = flow.log_prob(params, x)
        # f32 through searchsorted + quadratic-root inversion: ~2e-4 worst
        assert jnp.abs(lq - lq2).max() < 1e-3


@pytest.mark.parametrize("key", [0, 5])
@pytest.mark.parametrize("transform_type", ["real_nvp", "spline"])
@pytest.mark.parametrize("act_norm", [False, True])
def test_roundtrip_float64_any_key(transform_type, act_norm, key):
    """The inverse formulas are exact up to rounding at any key: in f64 the
    round trip holds even for flows whose f32 round trip is ill-conditioned
    (keys 0 and 5 give a nearly flat spline bin in both act_norm settings)."""
    with jax.enable_x64(True):
        flow, params = make_coupling_flow(
            jax.random.PRNGKey(key), dim=4, n_layers=4, hidden=(32, 32),
            transform_type=transform_type, act_norm=act_norm,
        )
        params = jax.tree.map(lambda p: p.astype(jnp.float64), _perturbed(params))
        u = jax.random.normal(jax.random.PRNGKey(1), (16, 4), jnp.float64)
        x, ld_f = flow.forward(params, u)
        u_back, ld_i = flow.inverse(params, x)
        assert x.dtype == jnp.float64
        assert jnp.abs(u_back - u).max() < 1e-6
        assert jnp.abs(ld_f + ld_i).max() < 1e-6


def test_spline_identity_outside_box():
    """Points beyond the spline box pass through with zero logdet
    (linear tails), so densities stay finite for far-out samples."""
    flow, params = make_coupling_flow(
        jax.random.PRNGKey(0), dim=2, n_layers=2, hidden=(16,),
        transform_type="spline", spline_range=(-4.0, 4.0),
    )
    params = _perturbed(params)
    u = jnp.array([[50.0, -70.0], [5.0, -5.0]])
    x, ld = flow.forward(params, u)
    assert jnp.allclose(x, u)
    assert jnp.allclose(ld, 0.0)
    assert jnp.isfinite(flow.log_prob(params, u)).all()


def test_rejects_unknown_transform():
    with pytest.raises(ValueError, match="transform_type"):
        make_coupling_flow(jax.random.PRNGKey(0), 2, transform_type="planar")
