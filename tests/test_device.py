"""What decides where the program runs and what it reports: the compile
cache's place, the roofline's peak table, and chip_smoke's refusal to run
anywhere but on a GPU."""

import os
import sys
import types

import jax
import pytest

from mfm_tpu.diagnostics.roofline import device_peaks
from mfm_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore the cache directory so no later test compiles into it."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


class TestCompileCache:
    def test_env_var_wins(self, monkeypatch, cache_config, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", None)
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None  # set no other

    def test_default_is_fixed_dir_in_checkout(self, monkeypatch, cache_config):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        jax.config.update("jax_compilation_cache_dir", None)
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        # the same directory on every call: no PID, time or temp name in it
        assert compile_cache.enable_compile_cache() == got


class TestRooflinePeaks:
    def test_h100_lookup(self):
        h100 = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
        assert device_peaks(h100) == (67.0e12, 3.35e12)

    def test_unknown_gpu_raises(self):
        other = types.SimpleNamespace(platform="gpu", device_kind="Some Other GPU")
        with pytest.raises(KeyError, match="Some Other GPU"):
            device_peaks(other)

    def test_cpu_has_no_ceiling(self):
        assert device_peaks(jax.devices()[0]) == (None, None)


class TestChipSmokeGuard:
    def test_refuses_cpu_and_prints_no_result(self, capsys, cache_config):
        sys.path.insert(0, REPO)
        try:
            import chip_smoke
        finally:
            sys.path.remove(REPO)
        with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
            chip_smoke.main([])
        assert '"ok"' not in capsys.readouterr().out
