"""Scalar root solvers for adaptive tempering.

Two solvers:

- ``dichotomy``  early-exit bisection in a ``lax.while_loop`` (parity with
  /root/reference/bblackjax/smc/solver.py:20-82)
- ``bisection``  **fixed-iteration** bisection in a ``fori_loop`` — the
  batched default: a static trip count keeps the tempering update free of
  data-dependent control flow so it fuses into the scanned training step
  (replaces the reference's jaxopt.Bisection dependency,
  exe_flow_matching.py:400).
"""


from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax


def bisection(
    fun: Callable,
    lower,
    upper,
    n_iters: int = 30,
):
    """Fixed-iteration bisection for a decreasing ``fun`` on [lower, upper].

    Conventions follow the tempering use case: if fun(upper) >= 0 the upper
    bound is returned (the whole remaining increment is admissible); after
    n_iters halvings the bracket midpoint error is (upper-lower) / 2^n_iters.
    """
    lower = jnp.asarray(lower, jnp.result_type(float))
    upper = jnp.asarray(upper, jnp.result_type(float))
    f_upper = fun(upper)

    def body(_, ab):
        a, b = ab
        mid = 0.5 * (a + b)
        f_mid = fun(mid)
        a = jnp.where(f_mid >= 0, mid, a)
        b = jnp.where(f_mid >= 0, b, mid)
        return (a, b)

    a, b = lax.fori_loop(0, n_iters, body, (lower, upper))
    root = 0.5 * (a + b)
    return jnp.where(f_upper >= 0, upper, root)


def dichotomy(
    fun: Callable,
    _start,
    min_delta,
    max_delta,
    eps: float = 1e-4,
    max_iter: int = 100,
):
    """Early-exit bisection (parity with the reference dichotomy solver).

    Assumes ``fun`` decreasing with fun(min_delta) > 0 > fun(max_delta); if
    fun(max_delta) > 0 returns max_delta, if fun(min_delta) < 0 returns NaN.
    """
    min_delta = jnp.asarray(min_delta, jnp.result_type(float))
    max_delta = jnp.asarray(max_delta, jnp.result_type(float))
    f_min, f_max = fun(min_delta), fun(max_delta)

    def cond(carry):
        i, a, b, f_a, f_b = carry
        return jnp.logical_and(i < max_iter, f_a - f_b > eps)

    def body(carry):
        i, a, b, f_a, f_b = carry
        mid = 0.5 * (a + b)
        f_mid = fun(mid)
        take_low = f_mid < 0
        a = jnp.where(take_low, a, mid)
        f_a = jnp.where(take_low, f_a, f_mid)
        b = jnp.where(take_low, mid, b)
        f_b = jnp.where(take_low, f_mid, f_b)
        return (i + 1, a, b, f_a, f_b)

    def solve(_):
        _, a, _, _, _ = lax.while_loop(cond, body, (0, min_delta, max_delta, f_min, f_max))
        return a

    return jnp.where(
        f_max > 0,
        max_delta,
        jnp.where(f_min > 0, solve(None), jnp.nan),
    )
