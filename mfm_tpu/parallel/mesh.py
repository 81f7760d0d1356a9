"""Mesh and sharding utilities for chain-ensemble parallelism.

The reference is single-device; its only multi-device surface is a pluggable
``batch_fn=jax.pmap`` in the unused ATESS module
(/root/reference/bblackjax/adaptation/atess.py:23,71). Here multi-chip is a
first-class axis layout (SURVEY.md section 2.8):

- ``chains``   data-parallel axis: chain/particle states (n_chain, d) are
  sharded on their leading axis; kernels are elementwise across chains so
  stepping needs **zero** communication; FM-loss gradients reduce across devices
  with the psum XLA inserts for the replicated-parameter jit.
- ``ensemble`` ensemble-chain-adaptation axis: parameter rotation between
  chain batches is a ``ppermute`` ring (mfm_tpu.adaptation).

Sharding is annotation-driven: put the chain state on the mesh with
``shard_chains`` and jit propagates the layout through the entire scanned
training step.
"""

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("ensemble", "chains"),
    devices=None,
) -> Mesh:
    """Create a device mesh. Default: all devices on the last axis.

    ``shape`` of e.g. (2, 4) lays 8 chips as 2 ensembles x 4 chain shards.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def chain_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading (chain) axis over every mesh axis jointly."""
    spec = P(tuple(mesh.axis_names), *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_chains(tree, mesh: Mesh):
    """Device-put every leaf with its leading axis sharded across the mesh."""

    def put(leaf):
        return jax.device_put(leaf, chain_sharding(mesh, max(leaf.ndim, 1)))

    return jax.tree_util.tree_map(put, tree)


def replicate(tree, mesh: Mesh):
    sharding = replicated(mesh)
    return jax.tree_util.tree_map(lambda leaf: jax.device_put(leaf, sharding), tree)
