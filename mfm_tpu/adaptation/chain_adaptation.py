"""Cross-chain and ensemble-chain adaptation scaffolding.

Parity with /root/reference/bblackjax/adaptation/chain_adaptation.py:

- ``cross_chain``    re-fit kernel parameters (e.g. flow weights) from ALL
  chains each step, then advance all chains with the refreshed kernel.
- ``parallel_eca``   ensemble chain adaptation over a (num_batch, batch_size)
  chain grid: each batch carries its own parameters, parameters **rotate**
  between batches every iteration, and the batch whose data just trained the
  incoming parameters skips its move (chain_adaptation.py:72-85).

Mesh redesign: the reference's multi-device story is a pluggable
``batch_fn=jax.pmap``. Here the ensemble axis is a mesh axis:

- single-device: batches live on a leading array axis, rotation is
  ``jnp.roll``, the per-batch kernel is ``vmap``-lifted;
- multi-chip: wrap the update in ``shard_map`` over the ``ensemble`` mesh
  axis and the rotation lowers to ``lax.ppermute`` — one device-to-device hop per step
  (see mfm_tpu.parallel and tests/test_adaptation.py).
"""

from typing import Callable, NamedTuple, Tuple, Union

import jax
import jax.numpy as jnp



class AdaptState(NamedTuple):
    states: NamedTuple  # chain states, leading axis = chains (or batches)
    step: Union[jax.Array, int]


def cross_chain(
    kernel_factory: Callable,
    parameter_gn: Callable,
    num_chain: int,
):
    """Adaptation where every step re-derives kernel parameters from the
    whole ensemble.

    kernel_factory(*params) -> ensemble kernel (key, states) -> (states, info)
    parameter_gn(states, step, *params) -> new params
    """

    def init(initial_states: NamedTuple) -> AdaptState:
        leading = {
            leaf.shape[0]
            for leaf in jax.tree_util.tree_leaves(initial_states)
        }
        if leading != {num_chain}:
            raise ValueError(
                f"cross_chain expects every state leaf to lead with "
                f"(num_chain={num_chain}, ...); got leading sizes {leading}"
            )
        return AdaptState(initial_states, jnp.zeros((), jnp.int32))

    def update(
        rng_key: jax.Array, state: AdaptState, *params
    ) -> Tuple[AdaptState, tuple, NamedTuple]:
        new_params = parameter_gn(state.states, state.step, *params)
        kernel = kernel_factory(*new_params)
        new_states, infos = kernel(rng_key, state.states)
        return AdaptState(new_states, state.step + 1), new_params, infos

    return init, update


def _rotate(params, mesh=None, axis: str = "ensemble"):
    """Rotate per-batch parameters one slot forward: batch b receives the
    parameters batch b+1 just trained (reference chain_adaptation.py:72).

    Sharded path: each device holds an (n_local, ...) block of batches; a
    one-BATCH global rotation is a local shift plus a one-element ppermute
    ring — each device sends its first batch to its left neighbor.
    """
    if mesh is not None:
        n = mesh.shape[axis]
        perm = [(i, (i - 1) % n) for i in range(n)]  # src -> dst

        def rot(p):
            recv = jax.lax.ppermute(p[:1], axis, perm)
            return jnp.concatenate([p[1:], recv], axis=0)

        return jax.tree_util.tree_map(rot, params)
    return jax.tree_util.tree_map(
        lambda p: jnp.concatenate([p[1:], p[:1]], axis=0), params
    )


def parallel_eca(
    kernel_factory: Callable,
    parameter_gn: Callable,
    num_batch: int,
    batch_size: int,
    mesh=None,
    axis: str = "ensemble",
):
    """Ensemble chain adaptation with parameter rotation.

    States lead with (num_batch, batch_size, ...); params lead with
    (num_batch, ...). With ``mesh`` given, the update runs under
    ``shard_map`` over the ensemble mesh axis and rotation is a ppermute
    ring over the devices.
    """

    def init(initial_states: NamedTuple) -> AdaptState:
        leading = {
            leaf.shape[:2] for leaf in jax.tree_util.tree_leaves(initial_states)
        }
        if leading != {(num_batch, batch_size)}:
            raise ValueError(
                "parallel_eca expects state leaves leading with "
                f"(num_batch={num_batch}, batch_size={batch_size}, ...); "
                f"got {leading}"
            )
        return AdaptState(initial_states, jnp.zeros((), jnp.int32))

    def _one_batch(rng_key, skip, batch_states, batch_params):
        kernel = kernel_factory(*batch_params)
        moved, _ = kernel(rng_key, batch_states)
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(skip, a, b), moved, batch_states
        )

    def _update_local(rng_key, states, step, params):
        """Body operating on the full (num_batch, ...) arrays (vmap path)."""
        new_params = jax.vmap(
            lambda s, *p: parameter_gn(s, step, *p)
        )(states, *params)
        rotated = _rotate(new_params)
        keys = jax.random.split(rng_key, num_batch)
        # the batch whose freshly-trained params rotated away skips this move
        skip = jnp.arange(num_batch) != (step % num_batch)
        new_states = jax.vmap(_one_batch)(keys, skip, states, rotated)
        return new_states, new_params

    def _update_sharded(rng_key, states, step, params):
        """shard_map body: each device holds its batch slice; rotation is a
        ppermute ring over the ensemble axis."""
        from jax.sharding import PartitionSpec as P

        shard_map = jax.shard_map

        def body(key_block, states_block, *params_block):
            idx = jax.lax.axis_index(axis)
            n_local = key_block.shape[0]  # batches per device

            new_params = jax.vmap(
                lambda s, *p: parameter_gn(s, step, *p)
            )(states_block, *params_block)
            rotated = _rotate(new_params, mesh=mesh, axis=axis)
            local_batch_ids = idx * n_local + jnp.arange(n_local)
            skip = local_batch_ids != (step % num_batch)
            new_states = jax.vmap(_one_batch)(
                key_block, skip, states_block, rotated
            )
            return new_states, new_params

        keys = jax.random.split(rng_key, num_batch)
        spec = P(axis)
        return shard_map(
            body,
            mesh=mesh,
            in_specs=(spec, spec) + tuple(spec for _ in params),
            out_specs=(spec, spec),
            check_vma=False,
        )(keys, states, *params)

    def update(
        rng_key: jax.Array, state: AdaptState, *params
    ) -> Tuple[AdaptState, tuple, None]:
        if mesh is None:
            new_states, new_params = _update_local(
                rng_key, state.states, state.step, params
            )
        else:
            new_states, new_params = _update_sharded(
                rng_key, state.states, state.step, params
            )
        return AdaptState(new_states, state.step + 1), new_params, None

    return init, update
