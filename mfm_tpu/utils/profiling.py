"""Profiling helpers (capability the reference lacks — SURVEY.md section 5
notes it has wall-clock timing only).

``trace`` wraps a block in a jax.profiler trace whose dump can be opened in
TensorBoard / Perfetto; ``timed`` measures steady-state wall clock of a
jitted callable with compile excluded.
"""

import contextlib
import statistics
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: with trace("/tmp/trace"): run_chunk(...)"""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, repeats: int = 5, warmup: int = 1):
    """(median seconds per call, last output) of fn(*args), post-compile;
    every call is fenced by ``jax.block_until_ready``."""
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        start = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - start)
    return statistics.median(times), out
