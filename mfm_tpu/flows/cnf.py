"""CNF transport: batched push-forward / inverse with log-determinant.

Behavioral parity with the reference ``transform_and_logdet`` /
``inverse_and_logdet`` (/root/reference/exe_flow_matching.py:206-242), with
two batched-execution changes:

1. **Whole-ensemble transport.** One ODE solve carries the full (B, d)
   batch; every integrator stage is a single batched vector-field GEMM pass
   instead of B independent adaptive solves under vmap.
2. **Explicit log-det convention.** ``forward`` maps u -> x and returns
   ``logdet = int_0^1 div v(x_t, t) dt`` = log|det dx/du|, so the flow
   density is ``log q(x) = log q0(u) - logdet``. ``inverse`` maps x -> u and
   returns the *same* quantity accumulated along the reverse path (the
   reference encodes this via sign games on 'delta vol',
   exe_flow_matching.py:218-239; here the sign convention is explicit and
   tested by forward/inverse round-trips).

Divergence estimators (reference exe_flow_matching.py:211-217):

- ``exact``      trace of the per-sample Jacobian via vmapped ``jacfwd``
                 (O(d) extra forward passes; use for small d)
- ``hutchinson`` one Gaussian probe per sample per transform, a single
                 batched JVP per stage (the d > threshold default)
- ``exact_disc`` exact log|det| of the **discrete integrator map** itself
                 (no reference counterpart): one ``jax.linearize`` of the
                 whole fixed-grid map + d batched tangent columns + a
                 batched ``slogdet``. Both estimators above approximate the
                 *continuous* flow's logdet; the particles, however, are
                 moved by the discrete RK4/heun map T_h, whose exact
                 log-Jacobian differs by a deterministic O(h^p) amount
                 Delta(u). Any density built from the continuous estimate —
                 IS weights, flow-MH acceptance, flow-SMC tempering — then
                 targets a tilted surrogate whose normalizer is off by
                 log E[exp(Delta)]. Measured on the d=32 many-well at the
                 preset 24 RK4 steps, Delta is ~+2e-4 nats with the O(h^4)
                 grid decay (RESULTS.md) — real
                 but negligible at benchmark grids, and in particular NOT
                 the source of that target's -1.2-nat flow-SMC logZ bias
                 (RESULTS.md round 5). ``exact_disc`` removes it
                 identically at ~the same FLOP count as ``exact`` (d
                 whole-map JVPs vs d per-stage JVPs) plus a (B, d, d)
                 slogdet — small-d only by memory.
"""

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from mfm_tpu.flows.ode import odeint_grid, odeint_grid_save


def exact_divergence(apply_fn: Callable) -> Callable:
    """Exact div v(x, t) as d basis-vector JVPs, scanned and batched.

    Same O(d) forward-pass count as the reference's per-sample ``jacfwd``
    trace (exe_flow_matching.py:215-217) but each pass is one (B, d) batched
    JVP — whole-ensemble GEMMs instead of B vmapped per-sample Jacobians,
    and no (B, d, d) Jacobian materialization.

    ASSUMES ``apply_fn`` is batch-decoupled: sample b's output depends only
    on sample b's input (true for every vector field here — they are
    per-sample MLPs mapped over the batch). A batch-coupled field (batch
    norm, ensemble interactions) would make the batched-tangent trick
    silently wrong: the extracted diagonal would mix cross-sample Jacobian
    blocks. Shared with ``discrete_map_logdet``."""

    def div(params, x, t, probe=None):
        def body(acc, i):
            e = jnp.zeros_like(x).at[:, i].set(1.0)
            _, jv = jax.jvp(lambda u: apply_fn(params, u, t), (x,), (e,))
            return acc + jv[:, i], None

        acc, _ = jax.lax.scan(
            body, jnp.zeros(x.shape[:1], x.dtype), jnp.arange(x.shape[-1])
        )
        return acc

    return div


def hutchinson_divergence(apply_fn: Callable) -> Callable:
    """Hutchinson estimate probe^T (dv/dx) probe, one batched JVP per probe.

    ``probe`` is (B, d) or (K, B, d); K probes are averaged, cutting the
    estimator variance K-fold. The IS weights exp(log pi - log q) EXPONENTIATE
    the logdet noise (ESS fraction ~ exp(-sigma^2) under lognormal error), so
    at d=1600 eval-time probes are the difference between a degenerate and a
    usable importance sampler — see config.eval_hutchinson_probes."""

    def div(params, x, t, probe):
        def one(p):
            _, jvp = jax.jvp(lambda u: apply_fn(params, u, t), (x,), (p,))
            return jnp.sum(p * jvp, axis=-1)

        if probe.ndim == x.ndim:
            return one(probe)
        return jnp.mean(jax.vmap(one)(probe), axis=0)

    return div


def discrete_map_logdet(pos_map: Callable, u: jax.Array):
    """(x, log|det d pos_map / du|) of a batched discrete map, exactly.

    One ``jax.linearize`` shares the primal integration across all d tangent
    pushes (each a whole-ensemble (B, d) pass, scanned so the program size
    stays O(1) in d), then a batched ``slogdet`` of the assembled (B, d, d)
    Jacobian. Exact for the map actually applied to the particles — unlike
    the augmented-ODE divergence integral, which estimates the continuous
    flow's logdet and carries a deterministic O(h^p) discretization bias.

    ASSUMES ``pos_map`` is batch-decoupled (see ``exact_divergence``): the
    column push with e_i set across the WHOLE batch only assembles the true
    per-sample (B, d, d) Jacobian when sample b's output is independent of
    sample b' != b's input; a batch-coupled map would silently corrupt the
    slogdet.
    """
    x, f_jvp = jax.linearize(pos_map, u)

    def body(_, i):
        e = jnp.zeros_like(u).at[:, i].set(1.0)
        return None, f_jvp(e)

    _, cols = jax.lax.scan(body, None, jnp.arange(u.shape[-1]))
    # cols[i] = J @ e_i of shape (B, d)  ->  jac[b, :, i]
    jac = jnp.moveaxis(cols, 0, -1)
    _, logdet = jnp.linalg.slogdet(jac)
    return x, logdet


class Transport(NamedTuple):
    """Batched CNF transport functions.

    forward(params, u, key=None)  -> (x, logdet)   u: (B, d)
    inverse(params, x, key=None)  -> (u, logdet)
    forward_traj(params, u, save_ts, key=None) -> (S, B, d) trajectory
    """

    forward: Callable
    inverse: Callable
    forward_traj: Callable


def make_transport(
    apply_fn: Callable,
    divergence: str = "exact",
    n_steps: int = 24,
    method: str = "rk4",
    num_probes: int = 1,
    probe_dist: str = "gaussian",
) -> Transport:
    """Build ensemble transport for a batch-first vector field ``apply_fn``.

    ``divergence`` is 'exact' or 'hutchinson'. The Hutchinson path draws
    ``num_probes`` probes per sample per call from the supplied key
    (num_probes=1 gaussian is parity with the reference's per-transform
    probe, exe_flow_matching.py:211-214). ``probe_dist`` 'rademacher' has
    strictly lower trace-estimator variance than 'gaussian' (it zeroes the
    diagonal contribution); use more probes at evaluation time where the
    logdet noise otherwise destroys the IS weights.
    """
    if divergence == "exact_disc":
        return _make_exact_disc_transport(apply_fn, n_steps, method)
    div_fn = {
        "exact": exact_divergence,
        "hutchinson": hutchinson_divergence,
    }[divergence](apply_fn)
    needs_probe = divergence == "hutchinson"

    def _probe(key, x):
        if not needs_probe:
            return None
        if key is None:
            raise ValueError("hutchinson divergence requires a PRNG key")
        shape = x.shape if num_probes == 1 else (num_probes, *x.shape)
        if probe_dist == "rademacher":
            return (
                jax.random.rademacher(key, shape, jnp.int8).astype(x.dtype)
            )
        return jax.random.normal(key, shape, x.dtype)

    def _fwd_dyn(params, probe):
        def dyn(y, t):
            x, _ = y
            tb = jnp.full(x.shape[:1], t, x.dtype)
            return apply_fn(params, x, tb), div_fn(params, x, tb, probe)

        return dyn

    def _inv_dyn(params, probe):
        def dyn(y, s):
            x, _ = y
            tb = jnp.full(x.shape[:1], 1.0 - s, x.dtype)
            # reverse-time flow; logdet accumulates the same forward-map
            # divergence along the reverse path
            return -apply_fn(params, x, tb), div_fn(params, x, tb, probe)

        return dyn

    def forward(params, u, key: Optional[jax.Array] = None):
        y0 = (u, jnp.zeros(u.shape[:1], u.dtype))
        x, logdet = odeint_grid(
            _fwd_dyn(params, _probe(key, u)), y0, 0.0, 1.0, n_steps, method
        )
        return x, logdet

    def inverse(params, x, key: Optional[jax.Array] = None):
        y0 = (x, jnp.zeros(x.shape[:1], x.dtype))
        u, logdet = odeint_grid(
            _inv_dyn(params, _probe(key, x)), y0, 0.0, 1.0, n_steps, method
        )
        return u, logdet

    def forward_traj(params, u, save_ts, key: Optional[jax.Array] = None):
        y0 = (u, jnp.zeros(u.shape[:1], u.dtype))
        xs, _ = odeint_grid_save(
            _fwd_dyn(params, _probe(key, u)), y0, save_ts, n_steps, method
        )
        return xs

    return Transport(forward, inverse, forward_traj)


def _make_exact_disc_transport(
    apply_fn: Callable, n_steps: int, method: str
) -> Transport:
    """Transport whose logdet is the exact log-Jacobian of the discrete map.

    Same (x, logdet) contract and sign convention as the augmented-ODE
    paths: ``forward`` returns log|det dx/du| of the forward map, and
    ``inverse`` returns that same quantity, i.e. −log|det du/dx| of the
    reverse map. PRNG keys are accepted and ignored (no probes).
    """

    def _pos_fwd(params):
        def pos(u):
            def dyn(x, t):
                tb = jnp.full(x.shape[:1], t, x.dtype)
                return apply_fn(params, x, tb)

            return odeint_grid(dyn, u, 0.0, 1.0, n_steps, method)

        return pos

    def _pos_inv(params):
        def pos(x):
            def dyn(y, s):
                tb = jnp.full(y.shape[:1], 1.0 - s, y.dtype)
                return -apply_fn(params, y, tb)

            return odeint_grid(dyn, x, 0.0, 1.0, n_steps, method)

        return pos

    def forward(params, u, key: Optional[jax.Array] = None):
        del key
        return discrete_map_logdet(_pos_fwd(params), u)

    def inverse(params, x, key: Optional[jax.Array] = None):
        del key
        u, logdet_rev = discrete_map_logdet(_pos_inv(params), x)
        return u, -logdet_rev

    def forward_traj(params, u, save_ts, key: Optional[jax.Array] = None):
        del key

        def dyn(x, t):
            tb = jnp.full(x.shape[:1], t, x.dtype)
            return apply_fn(params, x, tb)

        return odeint_grid_save(dyn, u, save_ts, n_steps, method)

    return Transport(forward, inverse, forward_traj)


def flow_log_density(ref_log_prob: Callable, u: jax.Array, logdet: jax.Array):
    """log q(x) of a push-forward sample: log q0(u) - log|det dx/du|."""
    return ref_log_prob(u) - logdet
