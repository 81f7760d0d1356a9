"""Discrete normalizing flows: coupling layers (affine / rational-quadratic
spline) with exact forward AND inverse log-determinants.

This is the flow family the FAB baseline trains (reference
exe_others.py:42-76 delegates to the external ``fabjax`` RealNVP/spline
flows configured by config/flow/default.yaml:1-8; here the flow itself is
in-repo). Unlike the CNF transport (flows/cnf.py), a coupling flow needs no
ODE integration and its density is exact in both directions — which is what
FAB's importance weights require at every training step.

Design decisions:

- batch-first throughout: one coupling layer is two or three ``(B, h)``
  GEMMs for the whole ensemble; the layer stack is a Python loop over a
  STATIC layer count (unrolled by XLA, each layer has distinct params);
- mask-based conditioning instead of split/concat: the conditioner sees
  ``x * m`` and the transform applies where ``m == 0``, so shapes stay
  ``(B, d)`` with no gather/scatter, and parity masks alternate per layer;
- the RQ spline evaluates with ``searchsorted`` over a static K-bin grid
  plus ``take_along_axis`` — fixed shapes, no data-dependent control flow;
- identity initialization: the conditioner's output head is zero-init, and
  the spline parametrization maps zeros to uniform bins with unit boundary
  derivatives, so an untrained flow is the identity map (same principle as
  the CNF's zero-init output heads, exe_flow_matching.py:82-85).
"""

import dataclasses
from typing import Callable, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from mfm_tpu.flows.vector_field import dense, dense_init, mlp, mlp_init

_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3


def _softplus_inv(y: float) -> float:
    import math

    return math.log(math.expm1(y))


# bias added to raw derivative logits so zeros -> softplus^-1(1) -> unit
# derivative -> identity spline at init
_DERIV_BIAS = _softplus_inv(1.0 - _MIN_DERIV)


def _spline_params(raw, n_bins: int, lo: float, hi: float):
    """(..., 3K-1) raw conditioner output -> knot grids + derivatives.

    widths/heights: softmax -> at least _MIN_BIN per bin, summing to the
    box size; derivatives: softplus with the identity-at-zero bias, K+1
    values with the two boundary slopes pinned to 1 (linear tails).
    """
    w_raw = raw[..., :n_bins]
    h_raw = raw[..., n_bins : 2 * n_bins]
    d_raw = raw[..., 2 * n_bins :]  # (K-1) interior derivatives

    span = hi - lo
    widths = (_MIN_BIN + (1.0 - _MIN_BIN * n_bins) * jax.nn.softmax(w_raw)) * span
    heights = (_MIN_BIN + (1.0 - _MIN_BIN * n_bins) * jax.nn.softmax(h_raw)) * span
    derivs = _MIN_DERIV + jax.nn.softplus(d_raw + _DERIV_BIAS)
    ones = jnp.ones(derivs.shape[:-1] + (1,), derivs.dtype)
    derivs = jnp.concatenate([ones, derivs, ones], axis=-1)  # (K+1)

    xk = lo + jnp.cumsum(
        jnp.concatenate([jnp.zeros_like(widths[..., :1]), widths], -1), -1
    )
    yk = lo + jnp.cumsum(
        jnp.concatenate([jnp.zeros_like(heights[..., :1]), heights], -1), -1
    )
    return xk, yk, derivs


def _gather(knots, idx):
    return jnp.take_along_axis(knots, idx, axis=-1)[..., 0]


def rq_spline_forward(x, raw, n_bins: int, lo: float, hi: float):
    """Monotone rational-quadratic spline y(x) and log|dy/dx| (Durkan et
    al. 2019, eqs. 4-5). Identity with zero logdet outside [lo, hi]."""
    xk, yk, dk = _spline_params(raw, n_bins, lo, hi)
    inside = (x > lo) & (x < hi)
    xc = jnp.clip(x, lo + 1e-6, hi - 1e-6)

    # bin index: k such that xk[k] <= xc < xk[k+1]
    idx = jnp.sum((xc[..., None] >= xk[..., 1:-1]).astype(jnp.int32), -1,
                  keepdims=True)
    x0 = _gather(xk, idx)
    w = _gather(xk, idx + 1) - x0
    y0 = _gather(yk, idx)
    h = _gather(yk, idx + 1) - y0
    d0 = _gather(dk, idx)
    d1 = _gather(dk, idx + 1)
    s = h / w

    xi = (xc - x0) / w
    om = xi * (1.0 - xi)
    denom = s + (d1 + d0 - 2.0 * s) * om
    y = y0 + h * (s * xi * xi + d0 * om) / denom
    ld = (
        2.0 * jnp.log(s)
        + jnp.log(d1 * xi * xi + 2.0 * s * om + d0 * (1.0 - xi) ** 2)
        - 2.0 * jnp.log(denom)
    )
    return jnp.where(inside, y, x), jnp.where(inside, ld, 0.0)


def rq_spline_inverse(y, raw, n_bins: int, lo: float, hi: float):
    """Inverse spline x(y) and log|dx/dy| via the quadratic-root closed
    form (Durkan et al. 2019, eq. 6-8)."""
    xk, yk, dk = _spline_params(raw, n_bins, lo, hi)
    inside = (y > lo) & (y < hi)
    yc = jnp.clip(y, lo + 1e-6, hi - 1e-6)

    idx = jnp.sum((yc[..., None] >= yk[..., 1:-1]).astype(jnp.int32), -1,
                  keepdims=True)
    x0 = _gather(xk, idx)
    w = _gather(xk, idx + 1) - x0
    y0 = _gather(yk, idx)
    h = _gather(yk, idx + 1) - y0
    d0 = _gather(dk, idx)
    d1 = _gather(dk, idx + 1)
    s = h / w

    dy = yc - y0
    t = d1 + d0 - 2.0 * s
    a = h * (s - d0) + dy * t
    b = h * d0 - dy * t
    c = -s * dy
    # stable root in [0, 1]: 2c / (-b - sqrt(b^2 - 4ac))
    disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
    xi = (2.0 * c) / (-b - jnp.sqrt(disc))
    xi = jnp.clip(xi, 0.0, 1.0)
    x = x0 + xi * w

    om = xi * (1.0 - xi)
    denom = s + t * om
    ld_fwd = (
        2.0 * jnp.log(s)
        + jnp.log(d1 * xi * xi + 2.0 * s * om + d0 * (1.0 - xi) ** 2)
        - 2.0 * jnp.log(denom)
    )
    return jnp.where(inside, x, y), jnp.where(inside, -ld_fwd, 0.0)


def _conditioner_init(key, hidden: Sequence[int], n_out_per_dim: int, dim: int) -> dict:
    """Masked-input MLP emitting per-dimension transform parameters.

    Zero-init output head -> every coupling layer starts as the identity.
    """
    layers = mlp_init(key, dim, hidden)
    fan_in = hidden[-1] if hidden else dim
    layers[f"Dense_{len(hidden)}"] = dense_init(None, fan_in, dim * n_out_per_dim)
    return layers


def _conditioner(layers: dict, x_masked, n_out_per_dim: int):
    n_hidden = len(layers) - 1
    hidden = {f"Dense_{i}": layers[f"Dense_{i}"] for i in range(n_hidden)}
    h = mlp(hidden, x_masked, jax.nn.gelu)
    out = dense(layers[f"Dense_{n_hidden}"], h)
    return out.reshape(out.shape[:-1] + (x_masked.shape[-1], n_out_per_dim))


@dataclasses.dataclass(frozen=True)
class CouplingStack:
    """Alternating-mask coupling flow u <-> x.

    ``transform_type``: "real_nvp" (affine: 2 params/dim) or "spline"
    (monotone RQ: 3K-1 params/dim). ``forward`` maps base noise u -> data x
    (sampling direction); ``inverse`` maps x -> u (density direction).
    Parameters: ``{"params": {"conditioners_i": {"Dense_j": layer}}}``,
    plus ``an_scale`` / ``an_shift`` of shape (n_layers, dim) with act-norm.
    """

    dim: int
    n_layers: int
    hidden: Sequence[int]
    transform_type: str = "spline"
    n_bins: int = 8
    lo: float = -10.0
    hi: float = 10.0
    act_norm: bool = False

    @property
    def n_out(self) -> int:
        return 2 if self.transform_type == "real_nvp" else 3 * self.n_bins - 1

    def init(self, key: jax.Array) -> dict:
        keys = jax.random.split(key, self.n_layers)
        p = {
            f"conditioners_{i}": _conditioner_init(
                keys[i], self.hidden, self.n_out, self.dim
            )
            for i in range(self.n_layers)
        }
        if self.act_norm:
            p["an_scale"] = jnp.zeros((self.n_layers, self.dim), jnp.float32)
            p["an_shift"] = jnp.zeros((self.n_layers, self.dim), jnp.float32)
        return {"params": p}

    def _mask(self, i: int):
        par = jnp.arange(self.dim) % 2
        return jnp.where((i % 2) == 0, par, 1 - par).astype(jnp.float32)

    def _layer(self, p: dict, i: int, z, invert: bool):
        """One coupling layer (+ optional act-norm); returns (z', logdet)."""
        m = self._mask(i)
        free = 1.0 - m

        def couple(z):
            raw = _conditioner(p[f"conditioners_{i}"], z * m, self.n_out)
            if self.transform_type == "real_nvp":
                # bounded log-scale: tanh keeps |log s| <= 4 (fabjax-style
                # stability bound for affine couplings)
                log_s = 4.0 * jnp.tanh(raw[..., 0] / 4.0)
                shift = raw[..., 1]
                return log_s, shift
            return raw

        if not invert:
            if self.act_norm:
                z = z * jnp.exp(p["an_scale"][i]) + p["an_shift"][i]
                ld_an = jnp.sum(p["an_scale"][i]) * jnp.ones(z.shape[:-1])
            else:
                ld_an = jnp.zeros(z.shape[:-1])
            if self.transform_type == "real_nvp":
                log_s, shift = couple(z)
                z = jnp.where(free > 0, z * jnp.exp(log_s) + shift, z)
                ld = jnp.sum(free * log_s, -1)
            else:
                y, ld_el = rq_spline_forward(
                    z, couple(z), self.n_bins, self.lo, self.hi
                )
                z = jnp.where(free > 0, y, z)
                ld = jnp.sum(free * ld_el, -1)
            return z, ld + ld_an

        # inverse order: undo coupling, then act-norm
        if self.transform_type == "real_nvp":
            log_s, shift = couple(z)  # conditioner input z*m is untouched
            z = jnp.where(free > 0, (z - shift) * jnp.exp(-log_s), z)
            ld = -jnp.sum(free * log_s, -1)
        else:
            x, ld_el = rq_spline_inverse(
                z, couple(z), self.n_bins, self.lo, self.hi
            )
            z = jnp.where(free > 0, x, z)
            ld = jnp.sum(free * ld_el, -1)
        if self.act_norm:
            z = (z - p["an_shift"][i]) * jnp.exp(-p["an_scale"][i])
            ld = ld - jnp.sum(p["an_scale"][i])
        return z, ld

    def forward(self, params: dict, u):  # sampling direction
        ld = jnp.zeros(u.shape[:-1])
        z = u
        for i in range(self.n_layers):
            z, ldi = self._layer(params["params"], i, z, invert=False)
            ld = ld + ldi
        return z, ld

    def inverse(self, params: dict, x):
        ld = jnp.zeros(x.shape[:-1])
        z = x
        for i in reversed(range(self.n_layers)):
            z, ldi = self._layer(params["params"], i, z, invert=True)
            ld = ld + ldi
        return z, ld


class CouplingFlow(NamedTuple):
    """Functional handle: Gaussian base N(0, base_scale^2 I) + coupling stack.

    ``log_prob(params, x)`` is exact (inverse + base density + logdet);
    ``sample_and_log_prob(params, key, n)`` draws and scores in one pass —
    the pair FAB consumes every iteration.
    """

    forward: Callable  # (params, u) -> (x, logdet du->dx)
    inverse: Callable  # (params, x) -> (u, logdet dx->du)
    log_prob: Callable  # (params, x) -> (B,)
    sample: Callable  # (params, key, n) -> (n, d)
    sample_and_log_prob: Callable  # (params, key, n) -> ((n, d), (B,))
    dim: int


def _normal_logpdf(u, scale: float):
    d = u.shape[-1]
    return (-0.5 * jnp.sum(u * u, -1) / (scale * scale)
            - 0.5 * d * jnp.log(2.0 * jnp.pi)
            - d * jnp.log(scale))


def make_coupling_flow(
    key: jax.Array,
    dim: int,
    n_layers: int = 8,
    hidden: Sequence[int] = (128, 128),
    transform_type: str = "real_nvp",
    n_bins: int = 8,
    spline_range: Tuple[float, float] = (-10.0, 10.0),
    act_norm: bool = False,
    base_scale: float = 1.0,
) -> Tuple[CouplingFlow, dict]:
    """Build a coupling flow + init params (flow config parity:
    reference config/flow/default.yaml:1-8).

    ``base_scale`` widens the base Gaussian to N(0, base_scale^2 I): for
    box-scale targets (modes at +-8) an identity-init flow over N(0, I)
    starts ~8 sigma from the mass and FAB's q->p^2/q bootstrap expands it
    only logarithmically; a base matched to the target box is the same
    device the MFM path uses ('widegauss' ref dist, targets/REF_DISTS)."""
    if transform_type not in ("real_nvp", "spline"):
        raise ValueError(f"unknown transform_type {transform_type!r}")
    module = CouplingStack(
        dim=dim, n_layers=n_layers, hidden=tuple(hidden),
        transform_type=transform_type, n_bins=n_bins,
        lo=float(spline_range[0]), hi=float(spline_range[1]),
        act_norm=act_norm,
    )
    params = module.init(key)
    forward, inverse = module.forward, module.inverse

    def log_prob(params, x):
        u, ld = inverse(params, x)
        return _normal_logpdf(u, base_scale) + ld

    def sample(params, key, n: int):
        u = base_scale * jax.random.normal(key, (n, dim))
        return forward(params, u)[0]

    def sample_and_log_prob(params, key, n: int):
        u = base_scale * jax.random.normal(key, (n, dim))
        x, ld = forward(params, u)
        # log q(x) = log N(u) - log|det dx/du|
        return x, _normal_logpdf(u, base_scale) - ld

    flow = CouplingFlow(
        forward, inverse, log_prob, sample, sample_and_log_prob, dim
    )
    return flow, params
