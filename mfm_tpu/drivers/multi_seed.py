"""Vectorized multi-seed MFM replication.

The reference replicates every benchmark over 10 seeds with a host loop
(multi_modal.py:118-131), paying full compile + run time per seed. On an accelerator
the seeds are embarrassingly parallel *within one program*: this driver
vmaps the entire training run — per-seed network init (including per-seed
Fourier features), chain states, tempering levels and optimizer states —
so the whole replication is one scanned, jitted computation whose batched
GEMMs fill the device far better than any single small-seed run.

The per-seed pipeline is exactly ``drivers.mfm.build_mfm`` (shared code, no
drift): build_mfm is traceable, so it is simply called inside the vmapped
function. The interleave decision depends only on the shared step counter,
so the flow/MCMC ``lax.cond`` stays a real branch under vmap; only the
cheap tempering update degrades to a select.
"""

import time
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from mfm_tpu.config import MFMConfig
from mfm_tpu.drivers.mfm import build_mfm
from mfm_tpu.targets.base import Target


class SeedSweep(NamedTuple):
    positions: jax.Array  # (S, n_chain, d) final chain positions
    params: dict  # per-seed flow params (leading S axis)
    fourier: jax.Array  # (S, F) per-seed frequencies
    beta: jax.Array  # (S,)
    metrics: dict  # (S, n_iter) stacked scalars
    train_time: float


def run_mfm_seeds(target: Target, cfg: MFMConfig, seeds: Sequence[int]) -> SeedSweep:
    """Run the full MFM training for every seed in one vmapped program."""
    seed_arr = jnp.asarray(list(seeds), jnp.uint32)
    counts = jnp.arange(1, cfg.learning_iter + 1)

    def single_seed(seed):
        key = jax.random.PRNGKey(seed)
        key_build, key_pos, key_loop = jax.random.split(key, 3)
        pieces = build_mfm(target, cfg, key_build)
        carry = pieces.init_fn(target.init_positions(key_pos, cfg.num_chain))
        keys = jax.random.split(key_loop, cfg.learning_iter)
        carry, metrics = lax.scan(pieces.step_fn, carry, (keys, counts))
        return (
            carry.chain.position,
            carry.train.params,
            pieces.fourier,
            carry.beta,
            metrics,
        )

    sweep = jax.jit(jax.vmap(single_seed))
    out = sweep(seed_arr)  # compile + first run
    jax.block_until_ready(out)
    start = time.time()
    out = sweep(seed_arr)
    jax.block_until_ready(out)
    train_time = time.time() - start
    positions, params, fourier, beta, metrics = out
    return SeedSweep(positions, params, fourier, beta, metrics, train_time)
