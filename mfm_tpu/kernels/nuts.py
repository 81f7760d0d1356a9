"""No-U-Turn Sampler, ensemble-batched.

Part of the BASELINE north star MCMC-layer inventory (upstream blackjax has
NUTS; the vendored reference fork dropped it). Batched design:

The classic recursive tree build is data-dependent control flow per chain —
hostile to SPMD. Here the doubling recursion is **unrolled statically**
(Python recursion over tree depth), producing a fixed program of
2^max_depth - 1 batched leapfrog steps per kernel call. Every step advances
the WHOLE (B, d) ensemble; chains whose trajectory already terminated
(u-turn / divergence) are frozen by masks. This trades wasted masked work
for zero dynamic control flow — the standard SIMD-NUTS bargain — and makes
each leapfrog one fused batched score pass.

Semantics: multinomial NUTS (Betancourt 2017) — within-subtree multinomial
proposal sampling, biased progressive sampling across doublings, endpoint
u-turn criterion with inverse-mass-weighted velocities, divergence at
|H - H0| > divergence_threshold.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from mfm_tpu.kernels.base import ChainState, SamplingAlgorithm
from mfm_tpu.kernels.mala import init  # cached-state initializer


class NUTSInfo(NamedTuple):
    acceptance_rate: jax.Array  # (B,) mean MH acceptance over the trajectory
    is_divergent: jax.Array  # (B,)
    is_turning: jax.Array  # (B,)
    num_doublings: jax.Array  # (B,) realized tree depth
    energy: jax.Array  # (B,)


class _Z(NamedTuple):
    """One phase-space point per chain."""

    q: jax.Array
    p: jax.Array
    logdens: jax.Array
    grad: jax.Array


class _Tree(NamedTuple):
    """Per-chain subtree summary."""

    z_left: _Z
    z_right: _Z
    prop_q: jax.Array
    prop_logdens: jax.Array
    prop_grad: jax.Array
    log_weight: jax.Array  # logsumexp of -H over the subtree
    turning: jax.Array
    diverging: jax.Array
    sum_accept: jax.Array  # sum of min(1, exp(H0 - H)) over leaves
    n_leaves: jax.Array


def _where_z(mask, a: _Z, b: _Z) -> _Z:
    m = mask[:, None]
    return _Z(
        jnp.where(m, a.q, b.q),
        jnp.where(m, a.p, b.p),
        jnp.where(mask, a.logdens, b.logdens),
        jnp.where(m, a.grad, b.grad),
    )


def build_kernel(
    value_and_score: Callable,
    max_depth: int = 6,
    divergence_threshold: float = 1000.0,
    variant: str = "auto",
) -> Callable:
    """kernel(key, state, step_size, inverse_mass) -> (state, NUTSInfo).

    variant: 'static' (unrolled, 2^max_depth-1 leapfrogs in the program —
    fastest per step at shallow depth), 'iterative' (checkpointed loops,
    O(max_depth) program size), or 'auto' = static for max_depth <= 6,
    iterative above (where the unrolled program size explodes)."""
    if variant == "auto":
        variant = "static" if max_depth <= 6 else "iterative"
    if variant == "iterative":
        return build_kernel_iterative(
            value_and_score, max_depth, divergence_threshold
        )
    if variant != "static":
        raise ValueError(f"unknown NUTS variant {variant!r}")

    def leapfrog(z: _Z, step_size, inv_mass, direction) -> _Z:
        eps = direction[:, None] * step_size
        p = z.p + 0.5 * eps * z.grad
        q = z.q + eps * (inv_mass * p)
        logdens, grad = value_and_score(q)
        p = p + 0.5 * eps * grad
        return _Z(q, p, logdens, grad)

    def energy(z: _Z, inv_mass):
        return -z.logdens + 0.5 * jnp.sum(z.p * z.p * inv_mass, axis=-1)

    def is_uturn(z_left: _Z, z_right: _Z, inv_mass):
        dq = z_right.q - z_left.q
        return (jnp.sum(dq * (inv_mass * z_left.p), axis=-1) <= 0.0) | (
            jnp.sum(dq * (inv_mass * z_right.p), axis=-1) <= 0.0
        )

    def build_tree(depth, key, z_start: _Z, step_size, inv_mass, direction, h0, active):
        """Static recursion: returns the subtree grown from z_start in
        ``direction``. ``active`` masks chains still expanding."""
        if depth == 0:
            z = leapfrog(z_start, step_size, inv_mass, direction)
            z = _where_z(active, z, z_start)  # frozen chains do not move
            h = energy(z, inv_mass)
            delta = h0 - h
            delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
            diverging = active & (-delta > divergence_threshold)
            log_w = jnp.where(active, delta, -jnp.inf)
            accept = jnp.where(active, jnp.minimum(1.0, jnp.exp(delta)), 0.0)
            return _Tree(
                z, z, z.q, z.logdens, z.grad, log_w,
                jnp.zeros_like(diverging), diverging, accept,
                active.astype(jnp.float32),
            )

        key_l, key_r, key_m = jax.random.split(key, 3)
        left = build_tree(
            depth - 1, key_l, z_start, step_size, inv_mass, direction, h0, active
        )
        grow = active & ~left.turning & ~left.diverging
        right = build_tree(
            depth - 1, key_r, left.z_right, step_size, inv_mass, direction, h0, grow
        )

        # multinomial merge of proposals (uniform within the subtree)
        total = jnp.logaddexp(left.log_weight, right.log_weight)
        p_right = jnp.exp(right.log_weight - jnp.maximum(total, -jnp.inf))
        p_right = jnp.where(jnp.isnan(p_right), 0.0, p_right)
        take_right = grow & jax.random.bernoulli(key_m, jnp.clip(p_right, 0.0, 1.0))
        tr = take_right[:, None]
        prop_q = jnp.where(tr, right.prop_q, left.prop_q)
        prop_ld = jnp.where(take_right, right.prop_logdens, left.prop_logdens)
        prop_g = jnp.where(tr, right.prop_grad, left.prop_grad)

        # outermost points in the growth direction define the u-turn check;
        # both subtrees were built in the same direction, so left boundary is
        # left.z_left and right boundary is right.z_right
        turning_here = grow & is_uturn(
            _where_z(direction > 0, left.z_left, right.z_right),
            _where_z(direction > 0, right.z_right, left.z_left),
            inv_mass,
        )
        return _Tree(
            left.z_left,
            _where_z(grow, right.z_right, left.z_right),
            prop_q,
            prop_ld,
            prop_g,
            jnp.where(grow, total, left.log_weight),
            left.turning | jnp.where(grow, right.turning | turning_here, False),
            left.diverging | right.diverging,
            left.sum_accept + right.sum_accept,
            left.n_leaves + right.n_leaves,
        )

    def kernel(
        rng_key: jax.Array,
        state: ChainState,
        step_size: float,
        inverse_mass: Optional[jax.Array] = None,
    ) -> Tuple[ChainState, NUTSInfo]:
        B, d = state.position.shape
        inv_mass = jnp.ones(d) if inverse_mass is None else jnp.asarray(inverse_mass)
        key_mom, key_tree = jax.random.split(rng_key)
        eps = jax.random.normal(key_mom, (B, d), state.position.dtype)
        p0 = eps / jnp.sqrt(inv_mass)
        z0 = _Z(state.position, p0, state.logdensity, state.logdensity_grad)
        h0 = energy(z0, inv_mass)

        # trajectory state: ends, current proposal, total weight
        traj_left = z0
        traj_right = z0
        prop_q, prop_ld, prop_g = z0.q, z0.logdens, z0.grad
        log_w = jnp.zeros(B)  # exp(h0 - h(z0)) = 1
        active = jnp.ones(B, bool)
        turning = jnp.zeros(B, bool)
        diverging = jnp.zeros(B, bool)
        sum_accept = jnp.zeros(B)
        n_leaves = jnp.zeros(B)
        depths = jnp.zeros(B)

        keys = jax.random.split(key_tree, 3 * max_depth)
        for j in range(max_depth):
            key_dir, key_sub, key_acc = keys[3 * j], keys[3 * j + 1], keys[3 * j + 2]
            direction = jnp.where(
                jax.random.bernoulli(key_dir, 0.5, (B,)), 1.0, -1.0
            )
            start = _where_z(direction > 0, traj_right, traj_left)
            sub = build_tree(
                j, key_sub, start, step_size, inv_mass, direction, h0, active
            )
            valid = active & ~sub.turning & ~sub.diverging
            # biased progressive sampling across doublings: accept the new
            # subtree's proposal with prob min(1, w_sub / w_traj)
            p_take = jnp.exp(jnp.minimum(sub.log_weight - log_w, 0.0))
            take = valid & jax.random.bernoulli(key_acc, jnp.clip(p_take, 0.0, 1.0))
            tk = take[:, None]
            prop_q = jnp.where(tk, sub.prop_q, prop_q)
            prop_ld = jnp.where(take, sub.prop_logdens, prop_ld)
            prop_g = jnp.where(tk, sub.prop_grad, prop_g)
            log_w = jnp.where(valid, jnp.logaddexp(log_w, sub.log_weight), log_w)

            # extend the trajectory ends where the subtree was valid
            new_right = _where_z(
                valid & (direction > 0), sub.z_right, traj_right
            )
            new_left = _where_z(valid & (direction < 0), sub.z_right, traj_left)
            traj_right, traj_left = new_right, new_left

            full_turn = valid & is_uturn(traj_left, traj_right, inv_mass)
            turning = turning | sub.turning | full_turn
            diverging = diverging | sub.diverging
            sum_accept = sum_accept + sub.sum_accept
            n_leaves = n_leaves + sub.n_leaves
            depths = depths + valid.astype(jnp.float32)
            active = active & ~sub.turning & ~sub.diverging & ~full_turn

        new_state = ChainState(prop_q, prop_ld, prop_g)
        accept_rate = sum_accept / jnp.maximum(n_leaves, 1.0)
        info = NUTSInfo(
            accept_rate, diverging, turning, depths, energy(
                _Z(prop_q, p0, prop_ld, prop_g), inv_mass
            )
        )
        return new_state, info

    return kernel


def build_kernel_iterative(
    value_and_score: Callable,
    max_depth: int = 10,
    divergence_threshold: float = 1000.0,
) -> Callable:
    """Iterative (checkpointed) batched NUTS — same semantics and signature
    as ``build_kernel`` but with a program size of O(max_depth) instead of
    O(2^max_depth): ONE leapfrog sits inside a while_loop inside the
    doubling loop, so max_depth=10 compiles in seconds where the static
    unroll would emit 1023 copies of the score pass.

    U-turn checks inside a subtree use the power-of-two momentum-checkpoint
    scheme (Phan & Pradhan's iterative NUTS, the numpyro design): even leaf
    ``e`` is stored at checkpoint slot popcount(e); after odd leaf ``i``
    (with t trailing one-bits), the subtrees of sizes 2^1..2^t end at i and
    their left endpoints live at slots popcount(i)-1 .. popcount(i)-t.
    Within-subtree multinomial proposal sampling happens streamingly
    (reservoir sampling with log-weights), which is distribution-identical
    to the static tree's pairwise multinomial merges.
    """

    def leapfrog(z: _Z, step_size, inv_mass, direction) -> _Z:
        eps = direction[:, None] * step_size
        p = z.p + 0.5 * eps * z.grad
        q = z.q + eps * (inv_mass * p)
        logdens, grad = value_and_score(q)
        p = p + 0.5 * eps * grad
        return _Z(q, p, logdens, grad)

    def energy(z: _Z, inv_mass):
        return -z.logdens + 0.5 * jnp.sum(z.p * z.p * inv_mass, axis=-1)

    def uturn_between(q_l, p_l, z: _Z, inv_mass, direction):
        """Endpoint u-turn criterion between a stored checkpoint (q_l, p_l)
        and the current point, matching the static kernel's is_uturn.
        Leapfrogging with eps = direction*step traverses the SAME phase-space
        orbit (stored momenta are physical), so the criterion needs the
        physically-ordered dq: integration order for direction=+1, reversed
        for direction=-1 — hence the direction factor."""
        dq = direction[:, None] * (z.q - q_l)
        return (jnp.sum(dq * (inv_mass * p_l), axis=-1) <= 0.0) | (
            jnp.sum(dq * (inv_mass * z.p), axis=-1) <= 0.0
        )

    def popcount(n):
        return lax.population_count(n)

    def trailing_ones(n):
        # n & ~(n+1) isolates the trailing one-run (adding 1 carries
        # through exactly the trailing ones)
        return lax.population_count(n & ~(n + 1))

    def kernel(
        rng_key: jax.Array,
        state: ChainState,
        step_size: float,
        inverse_mass: Optional[jax.Array] = None,
    ) -> Tuple[ChainState, NUTSInfo]:
        B, d = state.position.shape
        inv_mass = jnp.ones(d) if inverse_mass is None else jnp.asarray(inverse_mass)
        key_mom, key_loop = jax.random.split(rng_key)
        eps0 = jax.random.normal(key_mom, (B, d), state.position.dtype)
        p0 = eps0 / jnp.sqrt(inv_mass)
        z0 = _Z(state.position, p0, state.logdensity, state.logdensity_grad)
        h0 = energy(z0, inv_mass)
        step = jnp.asarray(step_size, state.position.dtype)

        def subtree(key, z_start: _Z, n_leaves_sub, direction, active):
            """Grow 2^j = n_leaves_sub leaves from z_start; one leapfrog per
            while-loop iteration, with per-chain freeze masks."""
            ckpt_q = jnp.zeros((max_depth + 1, B, d), z_start.q.dtype)
            ckpt_p = jnp.zeros((max_depth + 1, B, d), z_start.p.dtype)
            init = (
                jnp.zeros((), jnp.int32),  # i: next leaf index
                key,
                z_start,  # current point
                ckpt_q,
                ckpt_p,
                z_start.q,  # streaming proposal
                z_start.logdens,
                z_start.grad,
                jnp.full((B,), -jnp.inf),  # subtree log weight
                jnp.zeros(B, bool),  # turning
                jnp.zeros(B, bool),  # diverging
                jnp.zeros(B),  # sum_accept
                jnp.zeros(B),  # n_leaves counted
            )

            def cond(carry):
                i = carry[0]
                turning, diverging = carry[9], carry[10]
                grow = active & ~turning & ~diverging
                return (i < n_leaves_sub) & jnp.any(grow)

            def body(carry):
                (i, key, z, cq, cp, pq, pld, pg, logw, turning, diverging,
                 sacc, nlv) = carry
                key, key_prop = jax.random.split(key)
                grow = active & ~turning & ~diverging

                z_new = leapfrog(z, step, inv_mass, direction)
                z_new = _where_z(grow, z_new, z)
                h = energy(z_new, inv_mass)
                delta = h0 - h
                delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
                div_new = grow & (-delta > divergence_threshold)
                leaf_w = jnp.where(grow & ~div_new, delta, -jnp.inf)
                accept = jnp.where(
                    grow, jnp.minimum(1.0, jnp.exp(delta)), 0.0
                )

                # streaming multinomial proposal within the subtree
                total = jnp.logaddexp(logw, leaf_w)
                p_take = jnp.exp(leaf_w - jnp.maximum(total, -jnp.inf))
                p_take = jnp.where(jnp.isnan(p_take), 0.0, p_take)
                take = grow & jax.random.bernoulli(
                    key_prop, jnp.clip(p_take, 0.0, 1.0)
                )
                tk = take[:, None]
                pq = jnp.where(tk, z_new.q, pq)
                pld = jnp.where(take, z_new.logdens, pld)
                pg = jnp.where(tk, z_new.grad, pg)
                logw = jnp.where(grow, total, logw)

                # checkpoint bookkeeping: even leaf i stored at slot
                # popcount(i); odd leaf i checks slots pc-1 .. pc-t
                pc = popcount(i)
                is_even = (i % 2) == 0
                slot = jnp.where(is_even, pc, 0)
                cq = jnp.where(
                    is_even,
                    lax.dynamic_update_index_in_dim(cq, z_new.q, slot, 0),
                    cq,
                )
                cp = jnp.where(
                    is_even,
                    lax.dynamic_update_index_in_dim(cp, z_new.p, slot, 0),
                    cp,
                )
                t_ones = trailing_ones(i)
                turn_new = jnp.zeros(B, bool)
                for s in range(max_depth + 1):
                    in_range = (
                        (~is_even)
                        & (s <= pc - 1)
                        & (s >= pc - t_ones)
                    )
                    turn_s = uturn_between(cq[s], cp[s], z_new, inv_mass, direction)
                    turn_new = turn_new | (in_range & turn_s)
                turning = turning | (grow & turn_new)
                diverging = diverging | div_new

                return (
                    i + 1, key, z_new, cq, cp, pq, pld, pg, logw,
                    turning, diverging, sacc + accept,
                    nlv + grow.astype(jnp.float32),
                )

            (i, key, z_end, _, _, pq, pld, pg, logw, turning, diverging,
             sacc, nlv) = lax.while_loop(cond, body, init)
            return _Tree(
                z_start, z_end, pq, pld, pg, logw, turning, diverging,
                sacc, nlv,
            )

        # outer doubling loop (bounded by max_depth, early exit when every
        # chain has terminated)
        init = (
            jnp.zeros((), jnp.int32),  # j
            key_loop,
            z0,  # traj_left
            z0,  # traj_right
            z0.q, z0.logdens, z0.grad,  # proposal
            jnp.zeros(B),  # log_w
            jnp.ones(B, bool),  # active
            jnp.zeros(B, bool),  # turning
            jnp.zeros(B, bool),  # diverging
            jnp.zeros(B),  # sum_accept
            jnp.zeros(B),  # n_leaves
            jnp.zeros(B),  # depths
        )

        def cond(carry):
            j, active = carry[0], carry[8]
            return (j < max_depth) & jnp.any(active)

        def body(carry):
            (j, key, tl, tr, pq, pld, pg, logw, active, turning, diverging,
             sacc, nlv, depths) = carry
            key, key_dir, key_sub, key_acc = jax.random.split(key, 4)
            direction = jnp.where(
                jax.random.bernoulli(key_dir, 0.5, (B,)), 1.0, -1.0
            )
            start = _where_z(direction > 0, tr, tl)
            sub = subtree(
                key_sub, start, jnp.left_shift(jnp.int32(1), j), direction,
                active,
            )
            valid = active & ~sub.turning & ~sub.diverging
            p_take = jnp.exp(jnp.minimum(sub.log_weight - logw, 0.0))
            take = valid & jax.random.bernoulli(
                key_acc, jnp.clip(p_take, 0.0, 1.0)
            )
            tk = take[:, None]
            pq = jnp.where(tk, sub.prop_q, pq)
            pld = jnp.where(take, sub.prop_logdens, pld)
            pg = jnp.where(tk, sub.prop_grad, pg)
            logw = jnp.where(valid, jnp.logaddexp(logw, sub.log_weight), logw)

            tr = _where_z(valid & (direction > 0), sub.z_right, tr)
            tl = _where_z(valid & (direction < 0), sub.z_right, tl)

            full_turn = valid & uturn_between(
                tl.q, tl.p, tr, inv_mass, jnp.ones(B)
            )
            turning = turning | sub.turning | full_turn
            diverging = diverging | sub.diverging
            sacc = sacc + sub.sum_accept
            nlv = nlv + sub.n_leaves
            depths = depths + valid.astype(jnp.float32)
            active = active & ~sub.turning & ~sub.diverging & ~full_turn
            return (
                j + 1, key, tl, tr, pq, pld, pg, logw, active, turning,
                diverging, sacc, nlv, depths,
            )

        (_, _, tl, tr, prop_q, prop_ld, prop_g, logw, active, turning,
         diverging, sum_accept, n_leaves, depths) = lax.while_loop(
            cond, body, init
        )

        new_state = ChainState(prop_q, prop_ld, prop_g)
        accept_rate = sum_accept / jnp.maximum(n_leaves, 1.0)
        info = NUTSInfo(
            accept_rate, diverging, turning, depths,
            energy(_Z(prop_q, p0, prop_ld, prop_g), inv_mass),
        )
        return new_state, info

    return kernel


def nuts(
    value_and_score: Callable,
    step_size: float,
    max_depth: int = 6,
    inverse_mass: Optional[jax.Array] = None,
) -> SamplingAlgorithm:
    kernel = build_kernel(value_and_score, max_depth)

    def init_fn(position):
        return init(position, value_and_score)

    def step_fn(rng_key, state):
        return kernel(rng_key, state, step_size, inverse_mass)

    return SamplingAlgorithm(init_fn, step_fn)
