"""ODE integrators for CNF transport.

The reference integrates with ``jax.experimental.ode.odeint`` (adaptive
dopri5, /root/reference/exe_flow_matching.py:345-349). Adaptive stepping is
hostile to batched accelerator execution: data-dependent ``while_loop`` trip counts prevent
static scheduling and serialize the chain ensemble behind its slowest
member. The default here is a **fixed-grid** integrator
(``lax.scan`` over a static step budget, SURVEY.md section 7 item 4) whose
every stage is one batched vector-field evaluation for the whole ensemble.
An adaptive RK45 (Dormand-Prince with PI step-size control) is kept as a
single-trajectory verification oracle.

All integrators act on pytrees, so the augmented state (x, logdet) of CNF
transport threads through unchanged.
"""

from functools import partial
from typing import Callable, Sequence

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

_tree_map = jax.tree_util.tree_map


def _axpy(a, x, y):
    """y + a * x over pytrees."""
    return _tree_map(lambda xi, yi: yi + a * xi, x, y)


def _rk4_step(f: Callable, y, t, dt):
    k1 = f(y, t)
    k2 = f(_axpy(dt / 2, k1, y), t + dt / 2)
    k3 = f(_axpy(dt / 2, k2, y), t + dt / 2)
    k4 = f(_axpy(dt, k3, y), t + dt)
    comb = _tree_map(
        lambda a, b, c, d: (a + 2.0 * b + 2.0 * c + d) / 6.0, k1, k2, k3, k4
    )
    return _axpy(dt, comb, y)


def _heun_step(f: Callable, y, t, dt):
    k1 = f(y, t)
    k2 = f(_axpy(dt, k1, y), t + dt)
    return _axpy(dt / 2, _tree_map(lambda a, b: a + b, k1, k2), y)


def _euler_step(f: Callable, y, t, dt):
    return _axpy(dt, f(y, t), y)

_STEPPERS = {"rk4": _rk4_step, "heun": _heun_step, "euler": _euler_step}


def odeint_grid(
    f: Callable,
    y0,
    t0: float = 0.0,
    t1: float = 1.0,
    n_steps: int = 20,
    method: str = "rk4",
):
    """Fixed-grid integration of dy/dt = f(y, t) from t0 to t1.

    Returns the final state only. ``f`` may be batched; each stage is then a
    single ensemble-wide evaluation.
    """
    step = _STEPPERS[method]
    dt = (t1 - t0) / n_steps
    ts = t0 + dt * jnp.arange(n_steps)

    def body(y, t):
        return step(f, y, t, dt), None

    yT, _ = lax.scan(body, y0, ts)
    return yT


def odeint_grid_save(
    f: Callable,
    y0,
    save_ts: Sequence[float],
    n_steps: int = 20,
    method: str = "rk4",
):
    """Fixed-grid integration reporting the state at each time in ``save_ts``.

    ``save_ts`` must start at the initial time. The step budget is split
    evenly across segments (used for the 4-mode progression plots, parity
    with the reference's 5 save points, exe_flow_matching.py:345-349).
    """
    save_ts = list(save_ts)
    n_seg = len(save_ts) - 1
    per_seg = max(1, n_steps // max(n_seg, 1))
    states = [y0]
    y = y0
    for a, b in zip(save_ts[:-1], save_ts[1:]):
        y = odeint_grid(f, y, a, b, per_seg, method)
        states.append(y)
    return _tree_map(lambda *xs: jnp.stack(xs), *states)


# ---------------------------------------------------------------------------
# Adaptive RK45 (Dormand-Prince 5(4)) — verification oracle.
# ---------------------------------------------------------------------------

# Butcher tableau (Dormand & Prince 1980)
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
# plain numpy, NOT jnp: a module-level jnp.array would initialize the JAX
# backend at import time (import purity — see .claude/skills/verify). jnp
# ops inside the integrator convert these at trace time.
_DP_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_DP_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)


def _flat_fn(f, y0):
    """Reduce a pytree ODE to a flat-vector ODE for the adaptive controller."""
    flat0, unravel = jax.flatten_util.ravel_pytree(y0)

    def ff(yflat, t):
        dy = f(unravel(yflat), t)
        return jax.flatten_util.ravel_pytree(dy)[0]

    return ff, flat0, unravel


@partial(jax.jit, static_argnums=(0,), static_argnames=("max_steps",))
def odeint_dopri5(
    f: Callable,
    y0,
    t0: float = 0.0,
    t1: float = 1.0,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    max_steps: int = 1000,
):
    """Adaptive Dormand-Prince 5(4) with a PI controller; single trajectory.

    Matches the reference's odeint tolerances (multi_modal.py:207-209).
    Use only for verification / CPU oracle runs; the production path is
    :func:`odeint_grid`.
    """
    ff, yflat, unravel = _flat_fn(f, y0)

    def rk_stages(y, t, h):
        ks = []
        for i in range(7):
            yi = y
            for j, a in enumerate(_DP_A[i]):
                yi = yi + h * a * ks[j]
            ks.append(ff(yi, t + h * _DP_C[i]))
        kmat = jnp.stack(ks)
        y5 = y + h * jnp.tensordot(_DP_B5, kmat, axes=1)
        y4 = y + h * jnp.tensordot(_DP_B4, kmat, axes=1)
        return y5, y5 - y4

    def err_norm(y, ynew, yerr):
        scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(ynew))
        return jnp.sqrt(jnp.mean(jnp.square(yerr / scale)))

    def cond(carry):
        t, y, h, n = carry
        return (t < t1) & (n < max_steps)

    def body(carry):
        t, y, h, n = carry
        h = jnp.minimum(h, t1 - t)
        ynew, yerr = rk_stages(y, t, h)
        err = err_norm(y, ynew, yerr)
        accept = err <= 1.0
        # PI-ish controller: grow/shrink by err^(-1/5), clamped
        factor = jnp.clip(0.9 * (err + 1e-10) ** -0.2, 0.2, 5.0)
        hnew = h * factor
        t = jnp.where(accept, t + h, t)
        y = jnp.where(accept, ynew, y)
        return (t, y, hnew, n + 1)

    h0 = (t1 - t0) * 0.05
    _, yT, _, _ = lax.while_loop(cond, body, (jnp.asarray(t0), yflat, h0, 0))
    return unravel(yT)
