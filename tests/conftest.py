"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators by forcing the
host platform to expose 8 CPU devices (SURVEY.md section 4). The jaxtyping
pytest plugin imports jax before this file runs, so the platform override
must go through jax.config (still effective until the first backend is
created), and XLA_FLAGS must be set before the CPU client initializes.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Tests verify numerics, so pin full matmul precision; the framework pins
# HIGHEST explicitly on its accuracy-critical einsums.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: OPT-IN ONLY (MFM_TEST_CACHE=1), and
# switched off otherwise even where the CLI under test points it at its
# default directory (mfm_tpu.utils.compile_cache). It cuts repeat suite
# runs severalfold, but it is NOT safe by default: a mesh-sharded
# executable DESERIALIZED from the cache hard-aborts (SIGABRT, no Python exception) when jax.enable_x64
# has been toggled earlier in the same process — minimal repro is one
# x64-context test followed by test_sharding's sharded step on a warm
# cache; each alone passes, cold compiles always pass, and the abort
# reproduces with jax_persistent_cache_enable_xla_caches both "all" and
# "none", so it is the serialized-executable round-trip itself (upstream
# jax/XLA CPU issue). A full-suite abort is strictly worse than slower
# repeat runs, so correctness wins by default. The dir is additionally
# keyed by a CPU-flags fingerprint so a host migration can never load
# foreign AOT code.
if os.environ.get("MFM_TEST_CACHE") == "1":

    def _host_fingerprint() -> str:
        import hashlib
        import platform

        try:
            with open("/proc/cpuinfo") as fh:
                src = next(line for line in fh if line.startswith("flags"))
        except (OSError, StopIteration):
            src = platform.machine() + platform.processor()
        return hashlib.sha1(src.encode()).hexdigest()[:10]

    _cache_dir = os.path.join(
        os.path.dirname(__file__), f".jax_cache-{_host_fingerprint()}"
    )
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")
else:
    jax.config.update("jax_enable_compilation_cache", False)

assert jax.devices()[0].platform == "cpu", (
    "tests must run on the virtual CPU mesh; a backend was initialized "
    f"before conftest could override the platform: {jax.devices()}"
)


@pytest.fixture(scope="session")
def devices():
    devs = jax.devices()
    assert len(devs) >= 8, f"expected >=8 virtual devices, got {len(devs)}"
    return devs


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
