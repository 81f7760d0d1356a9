"""Optimizer / train-state factory for the flow-matching model.

Parity with the reference training setup
(/root/reference/exe_flow_matching.py:93-198):

- AdamW with a weight-decay mask excluding biases and LayerNorm-like scales
  (:116-136)
- gradient clipping chained after AdamW, with a finite-guard as the NaN
  defense (reference wraps in ``optax.apply_if_finite(..., 10)``,
  :137,:184 — here folded into one fused update, see ``adamw_finite``)
- linear warmup -> linear decay-to-zero LR schedule (:189-198)

The train step itself lives in the drivers; this module only builds pure
optimizer state so it can be carried through ``lax.scan``.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax


class TrainState(NamedTuple):
    """Minimal pure-pytree train state (scan-friendly)."""

    step: jax.Array
    params: dict
    opt_state: optax.OptState


def decay_mask(params) -> dict:
    """True for parameters that should be weight-decayed: everything except
    biases and *norm scales (reference decay_mask_fn, :116-127)."""

    def keep(path, _):
        names = [str(getattr(k, "key", k)) for k in path]
        if names[-1] == "bias":
            return False
        joined = "".join(names).lower()
        return not any(tag in joined for tag in ("layernorm", "layer_norm", "ln"))

    return jax.tree_util.tree_map_with_path(keep, params)


def make_lr_schedule(
    num_train_steps: int, num_warmup_steps: int, learning_rate: float
) -> optax.Schedule:
    """Linear warmup then linear decay to zero (reference :189-198)."""
    warmup = optax.linear_schedule(0.0, learning_rate, max(num_warmup_steps, 1))
    decay = optax.linear_schedule(
        learning_rate, 0.0, max(num_train_steps - num_warmup_steps, 1)
    )
    return optax.join_schedules([warmup, decay], [num_warmup_steps])


class AdamWFiniteState(NamedTuple):
    count: jax.Array  # applied (finite) steps, drives schedule + bias corr.
    notfinite_count: jax.Array  # consecutive skipped steps
    mu: optax.Updates
    nu: optax.Updates


def adamw_finite(
    learning_rate_fn,
    b1: float,
    b2: float,
    eps: float,
    weight_decay: float,
    gradient_clip: float,
    nonfinite_patience: int,
) -> optax.GradientTransformation:
    """AdamW + update clipping + non-finite skip as ONE fused update.

    Semantically ``optax.apply_if_finite(chain(adamw, clip), patience)``:
    a non-finite gradient leaves params and both moments untouched and
    bumps a consecutive-failure counter (reset on success); after
    ``nonfinite_patience`` consecutive failures the NaN is propagated so
    the blow-up surfaces. The fusion story is why it is hand-written
    (profiled on the pines step on an earlier accelerator):

    - ``apply_if_finite`` compiles to an HLO conditional, and that
      conditional could not alias operands across branches — XLA copied
      the whole ~80 MB AdamW state through device memory every iteration;
    - a select-based wrapper (``where(finite, new, old)`` per leaf) fixes
      the cond but still materializes per-tensor select fusions that read
      both moment copies;
    - the gated-increment form ``m + f*(1-b1)*(g - m)`` needs no second
      copy at all: the whole leaf update (both moments, bias correction,
      weight decay, clip, gate) is one elementwise fusion reading
      (m, v, g, p) and writing (m, v, u) — the same memory traffic as
      plain AdamW.
    """

    def init_fn(params):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
        return AdamWFiniteState(
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32),
            zeros,
            jax.tree_util.tree_map(jnp.zeros_like, params),
        )

    def update_fn(grads, state, params):
        finite = jnp.all(
            jnp.stack([
                jnp.all(jnp.isfinite(g))
                for g in jax.tree_util.tree_leaves(grads)
            ])
        )
        gate = finite.astype(jnp.float32)
        poison = (~finite) & (state.notfinite_count >= nonfinite_patience)
        count = state.count + finite.astype(jnp.int32)
        # optax parity: schedule evaluated at the pre-increment applied
        # count (optax.scale_by_schedule), bias correction at the
        # post-increment one (optax.scale_by_adam)
        lr = learning_rate_fn(state.count)
        cf = count.astype(jnp.float32)
        bc1 = 1.0 - b1**cf
        bc2 = 1.0 - b2**cf
        mask = decay_mask(params)

        def leaf(m, v, g, p, decay):
            g = jnp.where(finite, g, 0.0)
            m2 = m + gate * (1.0 - b1) * (g - m)
            v2 = v + gate * (1.0 - b2) * (g * g - v)
            adam = (m2 / bc1) / (jnp.sqrt(v2 / bc2) + eps)
            u = -lr * (adam + (weight_decay * p if decay else 0.0))
            # where, not *gate: on a skipped step before any applied one,
            # count=0 makes the bias correction 0/0 and NaN*0 stays NaN
            u = jnp.where(finite, jnp.clip(u, -gradient_clip, gradient_clip), 0.0)
            return m2, v2, jnp.where(poison, jnp.nan, u)

        out = jax.tree_util.tree_map(leaf, state.mu, state.nu, grads, params, mask)
        mu = jax.tree_util.tree_map(lambda _, o: o[0], grads, out)
        nu = jax.tree_util.tree_map(lambda _, o: o[1], grads, out)
        updates = jax.tree_util.tree_map(lambda _, o: o[2], grads, out)
        notfinite = jnp.where(finite, 0, state.notfinite_count + 1)
        return updates, AdamWFiniteState(count, notfinite, mu, nu)

    return optax.GradientTransformation(init_fn, update_fn)


def make_optimizer(
    learning_rate_fn,
    weight_decay: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    gradient_clip: float = 1.0,
    nonfinite_patience: int = 10,
) -> optax.GradientTransformation:
    return adamw_finite(
        learning_rate_fn,
        b1=b1,
        b2=b2,
        eps=eps,
        weight_decay=weight_decay,
        gradient_clip=gradient_clip,
        nonfinite_patience=nonfinite_patience,
    )


def create_train_state(params, tx: optax.GradientTransformation) -> TrainState:
    import jax.numpy as jnp

    return TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))


def apply_gradients(state: TrainState, grads, tx) -> TrainState:
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(state.step + 1, params, opt_state)
