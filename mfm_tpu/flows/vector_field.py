"""CNF velocity field v(x, t): Fourier time features, three MLP trunks, and a
learned gate on the target score.

Architecture parity with the reference ``VectorFieldNet``
(/root/reference/exe_flow_matching.py:56-90):

- time embedding [cos(2 pi f t), sin(2 pi f t)] with random frequencies f
- separate t-trunk and x-trunk MLPs, a joint xt-trunk on their concat
- two zero-initialized output heads (so the flow starts as the identity map)
- output = head_xt(xt) + head_t(t) * score(x), with the score optionally
  clipped (enabled for dim > 128, reference exe_flow_matching.py:87-90,351)

The field is **batch-first**: ``(B, d)`` positions and ``(B,)`` times go
through the trunks as single large matrix products, so one ODE stage for the
whole chain ensemble is a handful of GEMMs rather than B vmapped
vector-matrix products. Single samples are handled by reshaping. The score
gate takes a *batched* score function so targets can fuse their gradient
batch (e.g. LGCP's triangular solves).

Plain JAX: parameters are a nested dict laid out as
``{"params": {"t_trunk": {"Dense_i": {"kernel", "bias"}}, "x_trunk",
"xt_trunk", "gate_head", "field_head"}}`` with LeCun-normal kernels and
zero biases (zero kernels on the two heads).
"""

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

NON_LINEARITIES = {
    "tanh": jax.nn.tanh,
    "elu": jax.nn.elu,
    "relu": jax.nn.relu,
    "gelu": jax.nn.gelu,
    "swish": jax.nn.swish,
}


def dense_init(key: Optional[jax.Array], fan_in: int, fan_out: int) -> dict:
    """One dense layer: a LeCun-normal kernel (all zeros when ``key`` is
    None, for identity-at-init output heads) and a zero bias."""
    shape = (fan_in, fan_out)
    if key is None:
        kernel = jnp.zeros(shape, jnp.float32)
    else:
        kernel = jax.nn.initializers.lecun_normal()(key, shape, jnp.float32)
    return {"kernel": kernel, "bias": jnp.zeros((fan_out,), jnp.float32)}


def dense(layer: dict, h: jax.Array, precision=None) -> jax.Array:
    return jnp.dot(h, layer["kernel"], precision=precision) + layer["bias"]


def mlp_init(key: jax.Array, fan_in: int, features: Sequence[int]) -> dict:
    """``{"Dense_i": layer}`` for a stack of ``features`` widths."""
    keys = jax.random.split(key, max(len(features), 1))
    layers = {}
    for i, width in enumerate(features):
        layers[f"Dense_{i}"] = dense_init(keys[i], fan_in, width)
        fan_in = width
    return layers


def mlp(layers: dict, h: jax.Array, act: Callable, precision=None) -> jax.Array:
    for i in range(len(layers)):
        h = act(dense(layers[f"Dense_{i}"], h, precision))
    return h


@dataclasses.dataclass(frozen=True, eq=False)
class VectorFieldNet:
    """Velocity field v(x, t) -> (B, d).

    Attributes
    ----------
    fourier_freqs : (F,) random frequencies, drawn once outside the net
        (reference exe_flow_matching.py:350: ``fourier_std * normal(F)``)
    score_fn : batched target score (B, d) -> (B, d), or None to disable the
        score-gating term (pure MLP field)
    precision : matmul precision of every layer. ``HIGHEST`` keeps the
        products in full f32; ``None`` lets the backend pick its default
        (TF32 on the tensor cores of an NVIDIA GPU). The forward and inverse
        transports use the same function either way.
    """

    fourier_freqs: jax.Array
    hidden_x: Sequence[int]
    hidden_t: Sequence[int]
    hidden_xt: Sequence[int]
    act: Callable = jax.nn.relu
    score_fn: Optional[Callable] = None
    score_clip: Optional[float] = None
    precision: Optional[jax.lax.Precision] = jax.lax.Precision.HIGHEST

    def init(self, key: jax.Array, dim: int) -> dict:
        k_t, k_x, k_xt = jax.random.split(key, 3)
        width_t = self.hidden_t[-1] if self.hidden_t else 2 * self.fourier_freqs.shape[0]
        width_x = self.hidden_x[-1] if self.hidden_x else dim
        width_xt = self.hidden_xt[-1] if self.hidden_xt else width_x + width_t
        return {
            "params": {
                "t_trunk": mlp_init(k_t, 2 * self.fourier_freqs.shape[0], self.hidden_t),
                "x_trunk": mlp_init(k_x, dim, self.hidden_x),
                "gate_head": dense_init(None, width_t, dim),
                "xt_trunk": mlp_init(k_xt, width_x + width_t, self.hidden_xt),
                "field_head": dense_init(None, width_xt, dim),
            }
        }

    def apply(self, params: dict, x: jax.Array, t) -> jax.Array:
        p = params["params"]
        single = x.ndim == 1
        if single:
            x = x[None, :]
        t = jnp.broadcast_to(jnp.asarray(t, x.dtype).reshape(-1), (x.shape[0],))

        # Fourier time features: (B, 2F)
        ang = (2.0 * jnp.pi) * t[:, None] * self.fourier_freqs[None, :]
        tfeat = jnp.concatenate([jnp.cos(ang), jnp.sin(ang)], axis=-1)

        signal_t = mlp(p["t_trunk"], tfeat, self.act, self.precision)
        signal_x = mlp(p["x_trunk"], x, self.act, self.precision)
        gate = dense(p["gate_head"], signal_t, self.precision)
        joint = jnp.concatenate([signal_x, signal_t], axis=-1)
        joint = mlp(p["xt_trunk"], joint, self.act, self.precision)
        field = dense(p["field_head"], joint, self.precision)

        if self.score_fn is not None:
            score = self.score_fn(x)
            if self.score_clip is not None:
                score = jnp.clip(score, -self.score_clip, self.score_clip)
            field = field + gate * score

        return field[0] if single else field


def make_vector_field(
    key: jax.Array,
    dim: int,
    score_fn: Optional[Callable] = None,
    hidden_x: Sequence[int] = (128, 128),
    hidden_t: Sequence[int] = (128, 128),
    hidden_xt: Sequence[int] = (128, 128),
    fourier_dim: int = 128,
    fourier_std: float = 1.0,
    non_linearity: str = "relu",
    score_clip: Optional[float] = None,
    precision: str = "highest",
):
    """Build the net and its initial parameters.

    Returns ``(apply_fn, params)`` where ``apply_fn(params, x, t)`` is
    batch-first. Defaults mirror the reference flags
    (/root/reference/multi_modal.py:156-180).

    ``precision``: 'highest' (default — full-f32 matmuls, safest for
    forward/inverse logdet consistency) or 'default' (the backend's default
    matmul precision — TF32 on an NVIDIA GPU; forward and inverse still use
    the identical function, so MH acceptance stays well-defined against the
    reduced-precision flow).
    """
    key_freq, key_init = jax.random.split(key)
    freqs = fourier_std * jax.random.normal(key_freq, (fourier_dim,))
    prec = jax.lax.Precision.HIGHEST if precision == "highest" else None
    net = VectorFieldNet(
        fourier_freqs=freqs,
        hidden_x=tuple(hidden_x),
        hidden_t=tuple(hidden_t),
        hidden_xt=tuple(hidden_xt),
        act=NON_LINEARITIES[non_linearity],
        score_fn=score_fn,
        score_clip=score_clip,
        precision=prec,
    )
    return net.apply, net.init(key_init, dim)
