"""Distributed (shard_map) systematic/stratified resampling.

SURVEY.md section 2.8 calls the global-cumsum resample "the one genuinely
distributed-hard op" (reference: /root/reference/bblackjax/smc/resampling.py
:124-135, a single-device cumsum + searchsorted). The plain jit path in
``mfm_tpu.smc.resampling`` works under sharding but makes XLA all-gather the
full weight vector to every device and run the cumsum + searchsorted
redundantly everywhere.

This module keeps the weights sharded. The algorithm (exact, not an
approximation — bit-identical ancestor indices to the single-device
resampler for the same key):

1. **Scalar prefix exchange** — each shard reduces its local weights to one
   scalar; an exclusive prefix sum over shards runs as a Hillis–Steele scan
   of log2(S) ``ppermute`` steps (scalars only on the wire).
2. **Local segment marking** — with its global cumsum offset, every shard
   knows the *global* cumulative weight C_j of each of its particles, and
   therefore the first output slot s_j each particle fills:
   s_j = searchsorted(grid, C_{j-1}, 'right') against the (implicitly
   shared) grid g_i = (i+u)/num_samples. Particles with zero slot count are
   masked; the rest scatter their global particle id at s_j into a local
   marks buffer. All comparisons use the identical float ops as the
   single-device searchsorted, which is what makes the result exact.
3. **One reduce-scatter + local cummax** — ``psum_scatter`` combines the
   marks and hands each shard its own slice of the output slots; a local
   cummax plus a log2(S)-step scalar max-scan across shards turns segment
   starts into per-slot ancestors.

Communication: one reduce-scatter of num_samples int32 (each device
*receives* num_samples/S values) plus O(log S) scalars — versus the jit
baseline's all-gather, where each device receives the full n-float weight
vector. Receive volume drops ~S×; worst-case send volume is the same
Ω(num_samples) (a single shard can own every output slot, so that bound is
inherent to exact systematic resampling).

Exactness: the algorithm is exact — verified bit-identical to the
single-device resampler under float64. Under float32 the *prefix sum
bracketing* differs (per-shard cumsum + scalar offsets vs one global
cumsum), so cumulative weights can shift by a few ulps, and an ancestor at
a grid point within that rounding moves by as many positions as there are
particles whose whole weight lies inside it — one or two positions on
~0.26% of slots at 2^17 softmax(2·N(0,1)) weights, on the CPU and on four
H100s alike. Both outputs remain valid systematic resamples of the same
weights.
"""

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def _ppermute_shift(x, axis: str, dist: int, size: int):
    """x from shard i-dist (zero-filled at the boundary)."""
    perm = [(i, i + dist) for i in range(size - dist)]
    return lax.ppermute(x, axis, perm)


def _inclusive_scan(local, axis: str, size: int, op):
    """Inclusive scan over the mesh axis (Hillis–Steele, log2(S) ppermutes).
    ``op`` must treat 0 as identity (holds for + and max on >=0 values)."""
    incl = local
    dist = 1
    while dist < size:
        incl = op(incl, _ppermute_shift(incl, axis, dist, size))
        dist *= 2
    return incl


def _canonical_offsets(local_sum, axis: str, size: int):
    """Every shard's exclusive weight offset, computed with ONE canonical
    sequential bracketing shared by all shards.

    A per-shard Hillis–Steele scan gives each shard a *differently
    bracketed* float sum, so shard s's last cumulative weight and shard
    s+1's offset can differ by an ulp — which lets two shards claim the
    same output slot. Instead, a ring of S-1 scalar ppermutes hands every
    shard all S shard totals; each shard then runs the identical unrolled
    sequential recurrence, making the boundary values bit-equal:
    offsets[s+1] == offsets[s] + local_sum[s] exactly.
    """
    shard = lax.axis_index(axis)
    sums = jnp.zeros((size,), local_sum.dtype).at[shard].set(local_sum)
    for r in range(1, size):
        received = lax.ppermute(
            local_sum, axis, [(i, (i + r) % size) for i in range(size)]
        )
        src = (shard - r) % size
        sums = sums.at[src].set(received)
    # unrolled sequential prefix: one fixed bracketing on every shard
    offs = []
    carry = jnp.zeros((), local_sum.dtype)
    for t in range(size):
        offs.append(carry)
        carry = carry + sums[t]
    return jnp.stack(offs), carry  # (S,) exclusive offsets, total


def _distributed_offset_resample(
    rng_key, weights, num_samples: int, axis: str, size: int, systematic: bool
):
    """shard_map body: weights is this shard's slice; returns this shard's
    slice of the (num_samples,) ancestor-index array."""
    n_local = weights.shape[0]
    shard = lax.axis_index(axis)

    # 1. scalar prefix exchange: local cumsum once; its last entry doubles
    # as the shard total so boundary floats match exactly (see
    # _canonical_offsets)
    local_cum = jnp.cumsum(weights)
    offsets, _ = _canonical_offsets(local_cum[-1], axis, size)
    offset = offsets[shard]

    # 2. local segment marking against the shared grid
    if systematic:
        u = jax.random.uniform(rng_key, ())
    else:
        u = jax.random.uniform(rng_key, (num_samples,))
    grid = (jnp.arange(num_samples, dtype=weights.dtype) + u) / num_samples

    # global cumsum, local slice. cum_prev must REPRODUCE the previous
    # particle's cum bit-exactly (shift, not subtract: offset + (c - w)
    # rounds differently than (offset + c) computed for the neighbor), and
    # the first entry must be the canonical shard offset itself.
    cum = offset + local_cum
    cum_prev = jnp.concatenate([offset[None], cum[:-1]])
    # first slot each particle fills / first slot of the next particle;
    # identical comparison semantics to searchsorted(cum, grid, 'left')
    s_start = jnp.searchsorted(grid, cum_prev, side="right")
    s_end = jnp.searchsorted(grid, cum, side="right")
    filled = s_end > s_start

    gid = shard * n_local + jnp.arange(n_local)  # global particle ids
    marks = jnp.zeros(num_samples, jnp.int32)
    marks = marks.at[jnp.clip(s_start, 0, num_samples - 1)].max(
        jnp.where(filled, gid + 1, 0).astype(jnp.int32)
    )

    # 3. combine marks, slice per shard, segment-fill by cummax
    slice_marks = lax.psum_scatter(marks, axis, scatter_dimension=0, tiled=True)
    local_fill = lax.cummax(slice_marks)
    carry_incl = _inclusive_scan(local_fill[-1], axis, size, jnp.maximum)
    # exclusive max-carry: drop own slice's contribution
    carry_excl = jnp.where(
        shard == 0,
        jnp.zeros((), jnp.int32),
        _ppermute_shift(carry_incl, axis, 1, size),
    )
    # clamp to 0 for the measure-zero u == 0.0 draw, where grid[0] == 0.0
    # leaves slot 0 unmarked (the single-device resampler clips the same
    # boundary case to particle 0)
    return jnp.maximum(jnp.maximum(local_fill, carry_excl) - 1, 0)


def distributed_systematic(
    rng_key, weights, num_samples: int, mesh: Mesh, axis: str = "chains"
) -> jax.Array:
    """Exact systematic resampling with weights sharded over ``axis``.

    Returns the (num_samples,) global ancestor indices, sharded evenly over
    ``axis``. Requires num_samples and len(weights) divisible by the axis
    size. Same key -> same ancestors as ``resampling.systematic``.
    """
    return _run(rng_key, weights, num_samples, mesh, axis, True)


def distributed_stratified(
    rng_key, weights, num_samples: int, mesh: Mesh, axis: str = "chains"
) -> jax.Array:
    return _run(rng_key, weights, num_samples, mesh, axis, False)


def _run(rng_key, weights, num_samples, mesh, axis, systematic_flag):
    size = mesh.shape[axis]
    if weights.shape[0] % size or num_samples % size:
        raise ValueError(
            f"particles ({weights.shape[0]}) and num_samples ({num_samples}) "
            f"must divide the '{axis}' mesh axis size {size}"
        )
    body = functools.partial(
        _distributed_offset_resample,
        num_samples=num_samples,
        axis=axis,
        size=size,
        systematic=systematic_flag,
    )
    spec_w = P(axis)
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), spec_w),
        out_specs=P(axis),
        check_vma=False,
    )
    return fn(rng_key, weights)


def make_distributed_resampler(
    name: str, mesh: Mesh, axis: str = "chains"
) -> Callable:
    """resample(key, weights, num_samples) with the smc.base signature."""
    fn = {
        "systematic": distributed_systematic,
        "stratified": distributed_stratified,
    }.get(name)
    if fn is None:
        raise ValueError(
            f"distributed resampling supports systematic|stratified, got {name!r}"
        )

    def resample(rng_key, weights, num_samples):
        return fn(rng_key, weights, num_samples, mesh, axis)

    return resample


def _ring_exchange_body(particles, ancestors, axis: str, size: int):
    """shard_map body: ``particles`` is this shard's (n_local, d) pre-
    resample block, ``ancestors`` this shard's (m_local,) slice of global
    ancestor ids; returns the (m_local, d) resampled block.

    The blocks travel once around the ring (S-1 ``ppermute`` steps); at
    each step every shard copies the rows whose global ids live in the
    block currently passing through. Peak memory is 2 blocks of
    (N/S, d) — the plain ``jnp.take`` path lets XLA all-gather the full
    (N, d) matrix to every device first.
    """
    n_local, _ = particles.shape
    shard = lax.axis_index(axis)
    out = jnp.zeros((ancestors.shape[0], particles.shape[1]), particles.dtype)
    block = particles
    for r in range(size):
        src = (shard - r) % size  # original owner of the block in hand
        local_idx = jnp.clip(ancestors - src * n_local, 0, n_local - 1)
        rows = jnp.take(block, local_idx, axis=0)
        mine = (ancestors // n_local) == src
        out = jnp.where(mine[:, None], rows, out)
        if r < size - 1:
            block = lax.ppermute(
                block, axis, [(i, (i + 1) % size) for i in range(size)]
            )
    return out


def distributed_take(
    particles: jax.Array,
    ancestors: jax.Array,
    mesh: Mesh,
    axis: str = "chains",
) -> jax.Array:
    """Post-resample particle exchange ``particles[ancestors]`` as a
    shard_map ppermute ring (VERDICT r2 item 3 / ROADMAP item 2).

    ``particles`` (N, d) and ``ancestors`` (M,) are both sharded over
    ``axis``; the result is the (M, d) resampled matrix, sharded the same
    way, with no all-gather of the particle matrix in the compiled HLO.
    Exact: elementwise equal to ``jnp.take(particles, ancestors, 0)``.
    """
    size = mesh.shape[axis]
    if particles.shape[0] % size or ancestors.shape[0] % size:
        raise ValueError(
            f"particles ({particles.shape[0]}) and ancestors "
            f"({ancestors.shape[0]}) must divide the '{axis}' mesh axis "
            f"size {size}"
        )
    body = functools.partial(_ring_exchange_body, axis=axis, size=size)
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return fn(particles, ancestors)


def make_distributed_gather(mesh: Mesh, axis: str = "chains") -> Callable:
    """gather_fn(particles, ancestors) for smc.base.step's gather hook."""

    def gather(particles, ancestors):
        return distributed_take(particles, ancestors, mesh, axis)

    return gather
