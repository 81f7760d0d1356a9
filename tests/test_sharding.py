"""Multi-chip sharding: mesh construction, sharded MFM step execution on the
virtual 8-device CPU mesh, sharded == unsharded numerics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfm_tpu.config import MFMConfig
from mfm_tpu.drivers.mfm import build_mfm
from mfm_tpu.parallel import chain_sharding, make_mesh, replicate, shard_chains
from mfm_tpu.targets import four_mode_mixture


def _tiny_cfg(n_chain=32):
    return MFMConfig(
        example="4-mode",
        dim=2,
        num_chain=n_chain,
        learning_iter=10,
        hidden_x=(16,),
        hidden_t=(16,),
        hidden_xt=(16,),
        fourier_dim=8,
        ode_steps=4,
        mcmc_per_flow_steps=1.0,
    )


class TestMesh:
    def test_make_mesh_shapes(self, devices):
        mesh = make_mesh((2, 4), ("ensemble", "chains"), devices[:8])
        assert mesh.shape == {"ensemble": 2, "chains": 4}
        mesh1 = make_mesh(devices=devices[:8])
        assert mesh1.shape["chains"] == 8

    def test_shard_chains_layout(self, devices):
        mesh = make_mesh((2, 4), ("ensemble", "chains"), devices[:8])
        x = jnp.zeros((32, 5))
        xs = shard_chains(x, mesh)
        assert xs.sharding == chain_sharding(mesh, 2)


class TestShardedMFMStep:
    @pytest.mark.slow
    def test_sharded_step_runs_and_matches(self, devices):
        """One MFM train step sharded over 8 devices must match the
        single-device result (same keys, same init)."""
        target = four_mode_mixture()
        cfg = _tiny_cfg()
        key = jax.random.PRNGKey(0)
        pieces = build_mfm(target, cfg, key)
        step_fn, init_fn = pieces.step_fn, pieces.init_fn
        carry0 = init_fn(target.init_positions(key, cfg.num_chain))

        @jax.jit
        def one_step(carry, key, count):
            return step_fn(carry, (key, count))

        # unsharded
        c_ref, m_ref = one_step(carry0, jax.random.PRNGKey(1), jnp.asarray(1))
        c_ref, m_ref2 = one_step(c_ref, jax.random.PRNGKey(2), jnp.asarray(2))

        # sharded
        mesh = make_mesh((2, 4), ("ensemble", "chains"), devices[:8])
        carry_s = carry0._replace(
            chain=shard_chains(carry0.chain, mesh),
            train=replicate(carry0.train, mesh),
            beta=replicate(carry0.beta, mesh),
        )
        with mesh:
            c_s, m_s = one_step(carry_s, jax.random.PRNGKey(1), jnp.asarray(1))
            c_s, m_s2 = one_step(c_s, jax.random.PRNGKey(2), jnp.asarray(2))

        np.testing.assert_allclose(
            np.asarray(c_ref.chain.position), np.asarray(c_s.chain.position),
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            float(m_ref["loss"]), float(m_s["loss"]), rtol=1e-4
        )
        np.testing.assert_allclose(
            float(m_ref2["loss"]), float(m_s2["loss"]), rtol=1e-4
        )

    @pytest.mark.slow  # ~70 s; the driver also runs this check externally
    def test_graft_dryrun(self, devices):
        import sys, os

        sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)

    @pytest.mark.slow
    def test_graft_dryrun_subprocess_hostile_platform(self):
        """dryrun_multichip runs in a FRESH process whose environment may
        preset a (possibly broken) accelerator platform. The entry must
        force the virtual CPU mesh itself; any module-level jnp.* constant
        in mfm_tpu would initialize the hostile backend at import time and
        fail before it can."""
        import os
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        # hostile preset: a platform that raises on first backend use
        env["JAX_PLATFORMS"] = "cuda"
        env.pop("XLA_FLAGS", None)
        proc = subprocess.run(
            [sys.executable, "-c",
             "import __graft_entry__; __graft_entry__.dryrun_multichip(8); "
             "print('DRYRUN_OK')"],
            cwd=repo, env=env, capture_output=True, text=True, timeout=600,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "DRYRUN_OK" in proc.stdout
