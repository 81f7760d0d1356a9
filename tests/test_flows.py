"""Flow layer: ODE integrators, CNF log-det correctness, divergence
estimators, FM losses, optimizer plumbing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfm_tpu.flows import (
    cond_fm_sample,
    flow_matching_loss,
    fm_sample,
    make_lr_schedule,
    make_optimizer,
    make_transport,
    make_vector_field,
    odeint_dopri5,
    odeint_grid,
    odeint_grid_save,
    ot_pair,
    sinkhorn_plan,
)
from mfm_tpu.flows.train import apply_gradients, create_train_state
from mfm_tpu.targets import IndepGaussian, four_mode_mixture


class TestODE:
    def test_linear_field_exact(self):
        """dx/dt = A x has solution expm(A) x0."""
        from scipy.linalg import expm

        A = jnp.array([[0.3, -0.2], [0.1, 0.4]])
        f = lambda y, t: y @ A.T
        x0 = jnp.array([[1.0, 2.0], [-1.0, 0.5]])
        xT = odeint_grid(f, x0, n_steps=32)
        expected = x0 @ jnp.asarray(expm(np.asarray(A))).T
        np.testing.assert_allclose(xT, expected, rtol=1e-5)

    def test_grid_save_endpoints(self):
        f = lambda y, t: -y
        x0 = jnp.ones((3, 2))
        traj = odeint_grid_save(f, x0, [0.0, 0.5, 1.0], n_steps=32)
        assert traj.shape == (3, 3, 2)
        np.testing.assert_allclose(traj[0], x0)
        np.testing.assert_allclose(traj[2], x0 * np.exp(-1.0), rtol=1e-5)

    def test_adaptive_matches_grid(self):
        f = lambda y, t: jnp.sin(3 * t) * y
        x0 = jnp.array([1.0, -2.0])
        grid = odeint_grid(f, x0, n_steps=64)
        adaptive = odeint_dopri5(f, x0, rtol=1e-7, atol=1e-7)
        np.testing.assert_allclose(grid, adaptive, rtol=1e-5)

    def test_pytree_state(self):
        f = lambda y, t: (y[0], jnp.sum(y[0], axis=-1))
        y0 = (jnp.ones((2, 3)), jnp.zeros(2))
        x, a = odeint_grid(f, y0, n_steps=16)
        np.testing.assert_allclose(x, np.exp(1.0), rtol=1e-5)


def _linear_field_apply(A):
    """Batch-first 'network': v(x, t) = x A^T, with known divergence tr(A)."""

    def apply_fn(params, x, t):
        single = x.ndim == 1
        xb = x[None] if single else x
        out = xb @ A.T
        return out[0] if single else out

    return apply_fn


class TestCNFLogdet:
    def test_linear_flow_logdet(self, key):
        """For v = A x the exact log|det| is tr(A)."""
        A = jnp.array([[0.5, 0.1], [-0.2, 0.3]])
        apply_fn = _linear_field_apply(A)
        transport = make_transport(apply_fn, divergence="exact", n_steps=24)
        u = jax.random.normal(key, (8, 2))
        x, logdet = transport.forward(None, u)
        from scipy.linalg import expm

        M = np.asarray(expm(np.asarray(A)))
        np.testing.assert_allclose(x, u @ M.T, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(logdet, np.trace(A) * np.ones(8), rtol=1e-5)

    @pytest.mark.slow
    def test_forward_inverse_roundtrip_mlp(self, key):
        target = four_mode_mixture()
        apply_fn, params = make_vector_field(
            key, 2, score_fn=target.score, hidden_x=(16,), hidden_t=(16,),
            hidden_xt=(16,), fourier_dim=8,
        )
        # make the flow non-trivial
        params = jax.tree_util.tree_map(
            lambda p: p + 0.05 * jnp.ones_like(p), params
        )
        transport = make_transport(apply_fn, divergence="exact", n_steps=32)
        u = jax.random.normal(jax.random.fold_in(key, 1), (16, 2))
        x, logdet_f = transport.forward(params, u)
        u_back, logdet_b = transport.inverse(params, x)
        np.testing.assert_allclose(u_back, u, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(logdet_b, logdet_f, rtol=1e-3, atol=1e-3)

    def test_hutchinson_unbiased(self, key):
        """Average Hutchinson logdet over probes approaches the exact one."""
        A = jnp.array([[0.5, 0.1], [-0.2, 0.3]])
        apply_fn = _linear_field_apply(A)
        exact_t = make_transport(apply_fn, divergence="exact", n_steps=16)
        hutch_t = make_transport(apply_fn, divergence="hutchinson", n_steps=16)
        u = jax.random.normal(key, (4, 2))
        _, ld_exact = exact_t.forward(None, u)
        # one transport call with each sample replicated 2000x -> 2000 probes
        reps = 2000
        u_rep = jnp.repeat(u, reps, axis=0)
        _, ld = hutch_t.forward(None, u_rep, key=jax.random.fold_in(key, 7))
        ld_mean = ld.reshape(4, reps).mean(axis=1)
        np.testing.assert_allclose(ld_mean, ld_exact, atol=0.06)

    def test_exact_disc_matches_jacfwd_slogdet(self, key):
        """exact_disc IS the slogdet of the discrete map's Jacobian — even
        on a coarse grid where the continuous divergence integral differs.
        """
        target = four_mode_mixture()
        apply_fn, params = make_vector_field(
            key, 2, score_fn=target.score, hidden_x=(16,), hidden_t=(16,),
            hidden_xt=(16,), fourier_dim=8,
        )
        params = jax.tree_util.tree_map(
            lambda p: p + 0.08 * jnp.ones_like(p), params
        )
        disc_t = make_transport(apply_fn, divergence="exact_disc", n_steps=2)
        cont_t = make_transport(apply_fn, divergence="exact", n_steps=2)
        u = jax.random.normal(jax.random.fold_in(key, 1), (6, 2))
        x_d, ld_d = disc_t.forward(params, u)
        x_c, ld_c = cont_t.forward(params, u)
        # identical positions: both push through the same discrete map
        np.testing.assert_allclose(x_d, x_c, rtol=1e-6, atol=1e-6)

        def fwd_single(u1):
            x, _ = disc_t.forward(params, u1[None])
            return x[0]

        _, ld_true = jnp.linalg.slogdet(jax.vmap(jax.jacfwd(fwd_single))(u))
        np.testing.assert_allclose(ld_d, ld_true, rtol=1e-5, atol=1e-5)
        # the continuous estimate is NOT the discrete map's logdet at 2 steps
        assert float(jnp.max(jnp.abs(ld_c - ld_true))) > 1e-4

    def test_exact_disc_inverse_roundtrip(self, key):
        """inverse returns log|det dx/du| of its own reverse map (sign
        convention parity with the augmented-ODE paths).

        The discrete reverse RK4 map is NOT the exact inverse of the
        discrete forward map; the round-trip residual is integrator
        discretization error, measured on this exact fixture as
        max|u_back - u| = 3.1e-3 / 1.0e-4 / 3.2e-6 and
        max|ld_b - ld_f| = 7.4e-2 / 5.5e-4 / 1.3e-5 at 24/48/96 steps
        (~32x per step doubling). Tolerances below give ~10x margin over
        the 48-step measurement; they are calibration, not accuracy goals.
        """
        target = four_mode_mixture()
        apply_fn, params = make_vector_field(
            key, 2, score_fn=target.score, hidden_x=(16,), hidden_t=(16,),
            hidden_xt=(16,), fourier_dim=8,
        )
        params = jax.tree_util.tree_map(
            lambda p: p + 0.05 * jnp.ones_like(p), params
        )
        transport = make_transport(
            apply_fn, divergence="exact_disc", n_steps=48
        )
        u = jax.random.normal(jax.random.fold_in(key, 2), (8, 2))
        x, ld_f = transport.forward(params, u)
        u_back, ld_b = transport.inverse(params, x)
        np.testing.assert_allclose(u_back, u, atol=1e-3)
        np.testing.assert_allclose(ld_b, ld_f, atol=5e-3)

    def test_divergence_mode_config(self):
        from mfm_tpu.config import MFMConfig

        assert MFMConfig(hutchinson=True).divergence == "hutchinson"
        assert (
            MFMConfig(hutchinson=True, divergence_mode="exact_disc").divergence
            == "exact_disc"
        )
        with pytest.raises(ValueError):
            _ = MFMConfig(divergence_mode="bogus").divergence

    def test_zero_init_net_is_near_score_free_identity(self, key):
        """Zero-initialized heads make v ~= 0 => flow ~= identity, logdet ~= 0."""
        apply_fn, params = make_vector_field(key, 2, score_fn=None)
        transport = make_transport(apply_fn, divergence="exact", n_steps=8)
        u = jax.random.normal(key, (4, 2))
        x, logdet = transport.forward(params, u)
        np.testing.assert_allclose(x, u, atol=1e-6)
        np.testing.assert_allclose(logdet, 0.0, atol=1e-6)


class TestPlainJaxField:
    """The vector field is plain JAX: a fixed parameter tree, LeCun-normal
    kernels with zero biases, and zero heads."""

    def _net(self, key, score_fn=None):
        from mfm_tpu.flows.vector_field import VectorFieldNet

        net = VectorFieldNet(
            fourier_freqs=jax.random.normal(key, (4,)), hidden_x=(8, 6),
            hidden_t=(5,), hidden_xt=(7,), score_fn=score_fn,
        )
        return net, net.init(jax.random.fold_in(key, 1), 3)

    def test_param_tree_keys_and_shapes(self, key):
        _, params = self._net(key)
        shapes = jax.tree_util.tree_map(lambda a: a.shape, params["params"])
        assert shapes == {
            "t_trunk": {"Dense_0": {"kernel": (8, 5), "bias": (5,)}},
            "x_trunk": {"Dense_0": {"kernel": (3, 8), "bias": (8,)},
                        "Dense_1": {"kernel": (8, 6), "bias": (6,)}},
            "xt_trunk": {"Dense_0": {"kernel": (11, 7), "bias": (7,)}},
            "gate_head": {"kernel": (5, 3), "bias": (3,)},
            "field_head": {"kernel": (7, 3), "bias": (3,)},
        }
        p = params["params"]
        for head in ("gate_head", "field_head"):
            assert not np.any(np.asarray(p[head]["kernel"]))
        assert not np.any(np.asarray(p["x_trunk"]["Dense_0"]["bias"]))
        assert np.std(np.asarray(p["x_trunk"]["Dense_1"]["kernel"])) > 0.1

    def test_zero_heads_identity_with_score_gate(self, key):
        """Both heads start at zero, so even the score-gated field is zero
        and the flow starts as the identity."""
        target = IndepGaussian(3, mean=2.0)
        net, params = self._net(key, score_fn=target.score)
        transport = make_transport(net.apply, divergence="exact", n_steps=4)
        u = jax.random.normal(key, (5, 3))
        x, logdet = transport.forward(params, u)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(u))
        np.testing.assert_array_equal(np.asarray(logdet), 0.0)

    def test_single_sample_matches_batch(self, key):
        net, params = self._net(key)
        params = jax.tree_util.tree_map(lambda a: a + 0.3, params)
        x = jax.random.normal(key, (4, 3))
        batch = net.apply(params, x, jnp.full((4,), 0.25))
        one = net.apply(params, x[2], 0.25)
        assert one.shape == (3,)
        np.testing.assert_allclose(one, batch[2], rtol=1e-6)

    def test_matches_layer_by_layer_numpy(self, key):
        """The apply is the reference architecture: Fourier features, t/x
        trunks, joint trunk on their concat, field head + gate * score."""
        target = IndepGaussian(3)
        net, params = self._net(key, score_fn=target.score)
        params = jax.tree_util.tree_map(
            lambda a: a + 0.1 * jax.random.normal(key, a.shape), params
        )
        P = jax.tree_util.tree_map(np.asarray, params["params"])
        x = np.asarray(jax.random.normal(key, (2, 3)))
        t = np.array([0.2, 0.7])
        relu = lambda h: np.maximum(h, 0.0)
        lin = lambda l, h: h @ l["kernel"] + l["bias"]
        ang = 2 * np.pi * t[:, None] * np.asarray(net.fourier_freqs)[None]
        st = relu(lin(P["t_trunk"]["Dense_0"], np.concatenate([np.cos(ang), np.sin(ang)], -1)))
        sx = relu(lin(P["x_trunk"]["Dense_1"], relu(lin(P["x_trunk"]["Dense_0"], x))))
        j = relu(lin(P["xt_trunk"]["Dense_0"], np.concatenate([sx, st], -1)))
        ref = lin(P["field_head"], j) + lin(P["gate_head"], st) * (-x)
        np.testing.assert_allclose(net.apply(params, jnp.asarray(x), jnp.asarray(t)), ref,
                                   rtol=1e-5, atol=1e-6)


class TestFMLosses:
    def test_fm_path_endpoints(self, key):
        """At t -> 1 the path point approaches the data sample (sigma small)."""
        samples = jnp.array([[3.0, -1.0]] * 512)
        batch = fm_sample(key, samples, sigma=1e-4)
        idx = jnp.argsort(batch.times)[-20:]
        np.testing.assert_allclose(
            batch.points[idx], samples[:20], atol=0.4
        )
        np.testing.assert_allclose(
            batch.targets, samples - (1 - 1e-4) * (batch.points - batch.times[:, None] * samples) / (1 - (1 - 1e-4) * batch.times)[:, None],
            rtol=1e-2, atol=1e-2,
        )

    def test_cond_fm_target_is_difference(self, key):
        ref = IndepGaussian(2)
        samples = jax.random.normal(key, (64, 2)) + 4.0
        batch = cond_fm_sample(key, samples, ref.sample, sigma=1e-4)
        assert batch.targets.shape == (64, 2)
        # E[target] = E[x1] - E[x0] = 4 - 0
        np.testing.assert_allclose(batch.targets.mean(axis=0), 4.0, atol=0.6)

    def test_loss_sum_semantics(self, key):
        """Loss is the SUM of squared residuals (reference :178): doubling the
        batch roughly doubles the loss for a zero field."""
        ref = IndepGaussian(2)
        apply_fn = lambda p, x, t: jnp.zeros_like(x)
        s1 = jax.random.normal(key, (256, 2))
        s2 = jnp.concatenate([s1, s1])
        l1 = flow_matching_loss(None, apply_fn, key, s1, 1e-4, ref.sample)
        l2 = flow_matching_loss(None, apply_fn, key, s2, 1e-4, ref.sample)
        assert 1.5 < float(l2 / l1) < 2.5

    def test_loss_grad_finite(self, key):
        target = four_mode_mixture()
        ref = IndepGaussian(2)
        apply_fn, params = make_vector_field(key, 2, score_fn=target.score)
        samples = target.sample(key, (32,))
        loss, grads = jax.value_and_grad(
            lambda p: flow_matching_loss(p, apply_fn, key, samples, 1e-4, ref.sample)
        )(params)
        assert jnp.isfinite(loss)
        flat = jax.flatten_util.ravel_pytree(grads)[0]
        assert jnp.all(jnp.isfinite(flat))

    def test_sinkhorn_doubly_stochastic(self, key):
        x = jax.random.normal(key, (16, 2))
        y = jax.random.normal(jax.random.fold_in(key, 1), (16, 2))
        diff = x[:, None] - y[None]
        plan = sinkhorn_plan(jnp.sum(diff * diff, -1))
        np.testing.assert_allclose(plan.sum(1), 1.0 / 16, rtol=1e-2)
        np.testing.assert_allclose(plan.sum(0), 1.0 / 16, rtol=1e-2)

    def test_ot_pair_shapes(self, key):
        x = jax.random.normal(key, (16, 2))
        y = jax.random.normal(jax.random.fold_in(key, 1), (16, 2)) + 5
        xs, ys = ot_pair(key, x, y)
        assert xs.shape == ys.shape == (16, 2)


class TestTrainState:
    @pytest.mark.slow
    def test_train_step_reduces_loss(self, key):
        target = four_mode_mixture()
        ref = IndepGaussian(2)
        apply_fn, params = make_vector_field(
            key, 2, score_fn=target.score, hidden_x=(32,), hidden_t=(32,), hidden_xt=(32,)
        )
        lr_fn = make_lr_schedule(200, 0, 1e-3)
        tx = make_optimizer(lr_fn)
        state = create_train_state(params, tx)
        samples = target.sample(key, (128,))

        @jax.jit
        def step(state, key):
            loss, grads = jax.value_and_grad(
                lambda p: flow_matching_loss(p, apply_fn, key, samples, 1e-4, ref.sample)
            )(state.params)
            return apply_gradients(state, grads, tx), loss

        losses = []
        for i in range(100):
            state, loss = step(state, jax.random.fold_in(key, i))
            losses.append(float(loss))
        assert np.mean(losses[-10:]) < np.mean(losses[:10])

    def test_nonfinite_grads_do_not_poison(self, key):
        apply_fn, params = make_vector_field(key, 2)
        tx = make_optimizer(make_lr_schedule(10, 0, 1e-3))
        state = create_train_state(params, tx)
        bad = jax.tree_util.tree_map(lambda p: jnp.full_like(p, jnp.nan), params)
        state2 = apply_gradients(state, bad, tx)
        flat = jax.flatten_util.ravel_pytree(state2.params)[0]
        assert jnp.all(jnp.isfinite(flat))  # finite guard skipped the update

    def test_fused_adamw_matches_optax_chain(self, key):
        """adamw_finite (one fused gated update, flows/train.py) must be
        numerically the optax apply_if_finite(chain(adamw, clip)) it
        replaced for speed — including skipped NaN steps that freeze the
        moments and the applied-step count."""
        import optax

        from mfm_tpu.flows.train import decay_mask

        params = {
            "dense": {
                "kernel": jax.random.normal(key, (32, 16)),
                "bias": jnp.zeros(16),
            },
            "layernorm_1": {"scale": jnp.ones(16)},
        }
        lr_fn = make_lr_schedule(100, 10, 1e-2)
        adamw = optax.adamw(
            learning_rate=lr_fn, b1=0.9, b2=0.999, eps=1e-8,
            weight_decay=1e-4, mask=decay_mask,
        )
        ref_tx = optax.apply_if_finite(
            optax.chain(adamw, optax.clip(1.0)), 10
        )
        new_tx = make_optimizer(lr_fn)

        def run(tx):
            @jax.jit
            def step(carry, i):
                p, s = carry
                g = jax.tree_util.tree_map(
                    lambda q: jax.random.normal(
                        jax.random.fold_in(key, i), q.shape
                    ) * 5.0,
                    p,
                )
                bad = (i == 7) | (i == 8)
                g = jax.tree_util.tree_map(
                    lambda x: jnp.where(bad, jnp.nan, x), g
                )
                u, s = tx.update(g, s, p)
                return (optax.apply_updates(p, u), s), None

            (p, _), _ = jax.lax.scan(
                step, (params, tx.init(params)), jnp.arange(50)
            )
            return jax.flatten_util.ravel_pytree(p)[0]

        ref, new = run(ref_tx), run(new_tx)
        assert jnp.all(jnp.isfinite(ref)) and jnp.all(jnp.isfinite(new))
        np.testing.assert_allclose(np.asarray(ref), np.asarray(new), atol=1e-5)

    def test_decay_mask(self, key):
        """Weight decay skips biases and norm scales, keeps every kernel."""
        from mfm_tpu.flows import decay_mask

        _, params = make_vector_field(
            key, 2, hidden_x=(4,), hidden_t=(4,), hidden_xt=(4,), fourier_dim=2
        )
        mask = decay_mask(params)
        assert jax.tree_util.tree_structure(mask) == jax.tree_util.tree_structure(params)
        flat = jax.tree_util.tree_flatten_with_path(mask)[0]
        for path, keep in flat:
            assert keep == (path[-1].key == "kernel"), path
        assert decay_mask({"LayerNorm_0": {"scale": jnp.ones(2)},
                           "Dense_0": {"kernel": jnp.ones(2)}}) == {
            "LayerNorm_0": {"scale": False}, "Dense_0": {"kernel": True}}

    def test_lr_schedule(self):
        fn = make_lr_schedule(100, 10, 1e-2)
        assert float(fn(0)) == 0.0
        np.testing.assert_allclose(float(fn(10)), 1e-2, rtol=1e-5)
        np.testing.assert_allclose(float(fn(100)), 0.0, atol=1e-9)


class TestEvalTransportOverrides:
    @pytest.mark.slow
    def test_eval_probes_plumbed_through_driver(self, key):
        """cfg.eval_hutchinson_probes / eval_ode_steps swap the MFMRun's
        eval-facing transport; sampling must work and stay finite."""
        from mfm_tpu.config import MFMConfig
        from mfm_tpu.drivers import run_mfm, sample_flow
        from mfm_tpu.targets import four_mode_mixture

        target = four_mode_mixture()
        cfg = MFMConfig(
            example="4-mode", dim=2, num_chain=16, learning_iter=8,
            chunk_size=8, hidden_x=(16,), hidden_t=(16,), hidden_xt=(16,),
            fourier_dim=8, ode_steps=4, hutchinson=True,
            eval_hutchinson_probes=4, eval_probe_dist="rademacher",
            eval_ode_steps=8,
        )
        run = run_mfm(target, cfg)
        flow_s, exact_s, log_w = sample_flow(run, key, 64, target)
        assert np.isfinite(np.asarray(flow_s)).all()
        assert np.isfinite(np.asarray(log_w)).all()


class TestMultiProbeHutchinson:
    def _transport(self, **kw):
        from mfm_tpu.flows.cnf import make_transport

        # linear field with known divergence: v = A x, div = tr(A)
        A = jnp.array([[0.3, 0.8, 0.0], [-0.5, -0.1, 0.2], [0.1, 0.0, 0.4]])

        def apply_fn(params, x, t):
            return x @ A.T

        return make_transport(
            apply_fn, divergence="hutchinson", n_steps=8, **kw
        ), float(jnp.trace(A))

    @pytest.mark.slow
    def test_probes_reduce_logdet_variance(self, key):
        t1, tr = self._transport(num_probes=1)
        t16, _ = self._transport(num_probes=16)
        u = jax.random.normal(key, (64, 3))

        def spread(transport, seed0):
            outs = [
                transport.forward({}, u, jax.random.PRNGKey(s))[1]
                for s in range(seed0, seed0 + 8)
            ]
            return float(jnp.std(jnp.stack(outs), axis=0).mean())

        s1, s16 = spread(t1, 0), spread(t16, 100)
        assert s16 < s1 / 2.0, (s1, s16)
        # unbiased: mean over keys near the exact logdet tr(A) * 1
        ld = jnp.stack(
            [t16.forward({}, u, jax.random.PRNGKey(s))[1] for s in range(8)]
        )
        np.testing.assert_allclose(float(ld.mean()), tr, rtol=0.1)

    @pytest.mark.slow
    def test_rademacher_exact_for_linear_field(self, key):
        """For a linear field, rademacher probes give eps^T A eps whose
        expectation is tr(A); with many probes the estimate tightens."""
        t_rad, tr = self._transport(num_probes=32, probe_dist="rademacher")
        u = jax.random.normal(key, (32, 3))
        _, ld = t_rad.forward({}, u, jax.random.PRNGKey(3))
        # per-sample estimates are noisy (the probe is shared across ODE
        # stages); the population mean must sit on tr(A)
        np.testing.assert_allclose(float(np.mean(ld)), tr, rtol=0.1)
        assert float(np.std(ld)) < 0.2
