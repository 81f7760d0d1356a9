"""Small pytree helpers used across the framework."""

import jax
import jax.numpy as jnp


def pytree_size(tree) -> int:
    """Total number of scalar entries in a pytree."""
    return sum(jnp.size(leaf) for leaf in jax.tree_util.tree_leaves(tree))


def host_chunked_scan(fn, carry, xs, chunk):
    """Drive a jitted ``fn(carry, xs_chunk) -> (carry, ys)`` scan in
    host-level chunks of ``chunk`` leading-axis elements.

    Semantically identical to one ``fn(carry, xs)`` call (the carry passes
    through; ys re-concatenate along axis 0), but no single XLA execution
    runs longer than a chunk; the baselines' whole-training-run scans route
    through this (chunk sizes are yet to be set from H100 measurements,
    ROADMAP D4). ``fn`` compiles at most twice (full chunk + remainder
    shape)."""
    n = jax.tree_util.tree_leaves(xs)[0].shape[0]
    chunk = max(1, min(int(chunk), n))
    ys = []
    for i in range(0, n, chunk):
        carry, y = fn(carry, jax.tree.map(lambda a: a[i : i + chunk], xs))
        ys.append(y)
    if len(ys) == 1:
        return carry, ys[0]
    return carry, jax.tree.map(lambda *a: jnp.concatenate(a, axis=0), *ys)


def ravel_batch(tree):
    """Flatten a pytree whose leaves share a leading batch axis to (B, D).

    Returns the flat (B, D) array and an ``unravel`` function mapping a
    (B, D) array back to the original structure.
    """
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    batch = leaves[0].shape[0]
    shapes = [leaf.shape[1:] for leaf in leaves]
    sizes = [int(jnp.prod(jnp.array(s))) if s else 1 for s in shapes]
    flat = jnp.concatenate([leaf.reshape(batch, -1) for leaf in leaves], axis=1)

    def unravel(arr):
        out, start = [], 0
        for shape, size in zip(shapes, sizes):
            chunk = arr[:, start : start + size]
            out.append(chunk.reshape((arr.shape[0],) + shape))
            start += size
        return jax.tree_util.tree_unflatten(treedef, out)

    return flat, unravel


def tree_stack(trees):
    """Stack a list of identical-structure pytrees along a new leading axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def gaussian_like(key, tree, mu=0.0, sigma=1.0):
    """N(mu, sigma^2) noise shaped like ``tree`` (counterpart of the
    reference's generate_gaussian_noise, bblackjax/util.py:57-82, without
    the ravel/unravel round-trip: per-leaf subkeys keep leaves independent)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    noise = [
        mu + sigma * jax.random.normal(k, leaf.shape, leaf.dtype)
        for k, leaf in zip(keys, leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, noise)


def linear_map(diag_or_dense, vec, *, precision="highest"):
    """y = A x with diagonal-vs-dense dispatch at full precision
    (counterpart of bblackjax/util.py:14-52)."""
    dtype = jnp.result_type(diag_or_dense.dtype, vec.dtype)
    a = diag_or_dense.astype(dtype)
    b = vec.astype(dtype)
    if a.ndim <= 1:
        return a * b
    return jax.lax.dot(a, b, precision=precision)
