"""Baseline adapters (FAB / flowMC / DDS) with a shared result schema.

Parity target: the reference baselines orchestrator
(/root/reference/exe_others.py) — FAB (:42-76), flowMC (:114-199), DDS
(:247-299). Each baseline runs through the external package's adapter when
that package is installed (``available()``), and otherwise through the
in-repo implementation — drivers/fab.py, drivers/flowmc.py,
drivers/dds.py — so every baseline EXECUTES in this environment. The
external adapters themselves are exercised with stub packages
(tests/test_baselines.py); the in-repo loops have their own live tests
(tests/test_fab.py, test_flowmc.py, test_dds.py).

Deliberate redesigns vs the reference:
- IS correction resamples in log space (reference exponentiates raw
  weights, :74-76/:197-199, which under/overflows in f32),
- one shared result container + row builder instead of four inline blocks.
"""

import importlib.util
import time
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from mfm_tpu.config import MFMConfig
from mfm_tpu.targets.base import Target


class BaselineResult(NamedTuple):
    flow_samples: jax.Array  # (n_eval, d) raw sampler output
    exact_samples: jax.Array  # (n_eval, d) after IS correction (or same)
    train_time: float
    extras: dict  # baseline-specific diagnostics (losses, acceptances, ...)


def is_resample(key, flow_samples, log_target, log_flow=None):
    """Self-normalized IS resampling in log space (shared with
    drivers.mfm.sample_flow_parts; reference exponentiates, :197-199).

    ``log_target`` is the raw log-weights when ``log_flow`` is None, or the
    target log-density with ``log_flow`` subtracted otherwise — one
    sanitization + resampling rule for every baseline."""
    log_w = log_target if log_flow is None else log_target - log_flow
    log_w = jnp.where(jnp.isnan(log_w), -jnp.inf, log_w)
    idx = jax.random.categorical(key, log_w, shape=(flow_samples.shape[0],))
    return flow_samples[idx], log_w


def available(package: str) -> bool:
    import sys

    if package in sys.modules:  # already imported (or stubbed in tests)
        return True
    try:
        return importlib.util.find_spec(package) is not None
    except (ValueError, ModuleNotFoundError):
        return False


def run_flowmc(
    target: Target, cfg: MFMConfig, seed: int = 0, n_eval: Optional[int] = None
) -> BaselineResult:
    """flowMC: MaskedCouplingRQSpline flow + MALA local sampler
    (reference exe_others.py:114-199)."""
    from flowMC.nfmodel.rqSpline import MaskedCouplingRQSpline
    from flowMC.sampler.MALA import MALA
    from flowMC.sampler.Sampler import Sampler

    n_eval = n_eval or cfg.eval_iter * cfg.num_chain
    key = jax.random.PRNGKey(seed)
    key_init, key_choice, key_sampler = jax.random.split(key, 3)

    n_layers = len(cfg.hidden_x) + len(cfg.hidden_t) + 4
    model = MaskedCouplingRQSpline(
        cfg.dim, n_layers, list(cfg.hidden_xt), n_layers, key_init
    )
    local_sampler = MALA(
        lambda x, data=None: target.log_prob(x), True,
        {"step_size": cfg.step_size},
    )
    # flowMC's documented entry wants its own key set (reference
    # exe_others.py:119,138); fall back to an independent child key so the
    # sampler's stream never correlates with the init/resampling draws
    try:
        from flowMC.utils.PRNG_keys import initialize_rng_keys

        sampler_keys = initialize_rng_keys(cfg.num_chain, seed=seed)
    except ImportError:
        sampler_keys = key_sampler
    steps = max(int(cfg.mcmc_per_flow_steps), 1)
    sampler = Sampler(
        cfg.dim,
        sampler_keys,
        jnp.zeros(cfg.dim),
        local_sampler,
        model,
        n_loop_training=max(cfg.learning_iter // steps, 1),
        n_loop_production=0,
        n_local_steps=steps,
        n_global_steps=steps,
        n_chains=cfg.num_chain,
        n_epochs=steps,
        learning_rate=cfg.learning_rate,
        max_samples=cfg.num_chain * (steps + 1),
        batch_size=cfg.num_chain,
        use_global=True,
    )
    init_positions = target.init_positions(jax.random.fold_in(key, 1), cfg.num_chain)
    start = time.time()
    sampler.sample(init_positions, None)
    train_time = time.time() - start

    flow_samples = jnp.asarray(sampler.sample_flow(n_eval))
    log_flow = jnp.asarray(sampler.evalulate_flow(flow_samples))  # [sic] flowMC API
    exact, log_w = is_resample(
        key_choice, flow_samples, target.log_prob(flow_samples), log_flow
    )
    extras = {}
    try:
        state = sampler.get_sampler_state(training=True)
        extras = {k: state[k] for k in ("local_accs", "global_accs", "loss_vals")
                  if k in state}
    except Exception:
        pass
    return BaselineResult(flow_samples, exact, train_time, extras)


def run_fab(
    target: Target, cfg: MFMConfig, seed: int = 0, n_eval: Optional[int] = None,
    config_path: str = "configs/fab",
) -> BaselineResult:
    """FAB: flow annealed importance-sampling bootstrap
    (reference exe_others.py:42-76; per-target hydra YAMLs :49-59, ported to
    configs/fab/ with the same group layout)."""
    import os

    from fabjax.train.generic_training_loop import train
    from experiments.setup_training import (
        setup_fab_config,
        setup_general_train_config,
    )
    from hydra import compose, initialize_config_dir

    config_name = {
        "pines": "cox",
        "4-mode": "funnel",
        "phi-four": "many_well",
        "gaussian-mixture": "gmm_v0",
    }[cfg.example]
    # resolve relative to the repo root (hydra's plain ``initialize`` treats
    # config_path as relative to the *calling module*, which would point
    # inside the package — initialize_config_dir takes an absolute dir)
    if not os.path.isabs(config_path):
        repo_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        config_path = os.path.join(repo_root, config_path)
    with initialize_config_dir(
        version_base=None, config_dir=config_path, job_name="fab"
    ):
        fab_cfg = compose(config_name=config_name)
    fab_cfg.training.seed = seed
    fab_cfg.flow.conditioner_mlp_units = list(cfg.hidden_xt)
    fab_cfg.training.n_epoch = cfg.learning_iter
    fab_cfg.training.batch_size = cfg.num_chain

    n_eval = n_eval or cfg.eval_iter * cfg.num_chain
    fab_config = setup_fab_config(fab_cfg, target)
    flow = fab_config.flow
    start = time.time()
    _, state = train(setup_general_train_config(fab_config))
    train_time = time.time() - start

    key = jax.random.PRNGKey(seed)
    flow_samples, log_flow = flow.sample_and_log_prob_apply(
        state.flow_params, key, (n_eval,)
    )
    exact, _ = is_resample(
        jax.random.fold_in(key, 1), flow_samples,
        target.log_prob(flow_samples), log_flow,
    )
    return BaselineResult(flow_samples, exact, train_time, {})


def run_dds(
    target: Target, cfg: MFMConfig, seed: int = 0, n_eval: Optional[int] = None
) -> BaselineResult:
    """DDS: denoising diffusion sampler, OU-DSTL reference process with the
    cos^2 step schedule (reference exe_others.py:247-299)."""
    from dds.configs.config import get_config, set_task
    from dds.train_dds import train_dds

    n_eval = n_eval or cfg.eval_iter * cfg.num_chain
    config = get_config()
    config = set_task(config, "mixture_well")
    config.model.reference_process_key = "oudstl"
    config.model.step_scheme_key = "cos_sq"
    config.model.input_dim = cfg.dim
    config.trainer.lnpi = target.log_prob
    config.model.target = target.log_prob
    config.model.exp_dds = True
    config.model.stl = False
    config.model.detach_stl_drift = False
    config.trainer.log_every_n_epochs = max(cfg.learning_iter // 10, 1)
    config.trainer.learning_rate = cfg.learning_rate
    config.trainer.epochs = cfg.learning_iter
    config.trainer.random_seed = seed
    config.model.fully_connected_units = list(cfg.hidden_xt)
    config.model.batch_size = cfg.num_chain
    config.model.elbo_batch_size = cfg.num_chain
    config.eval.seeds = n_eval

    out = train_dds(config)
    train_time = out[0]
    aug = out[-1]["aug"]
    flow_samples = jnp.asarray(aug[:, -1, : cfg.dim])
    energy_cost = jnp.asarray(aug[:, -1, -1])
    stl = jnp.asarray(aug[:, -1, cfg.dim])
    terminal = config.model.terminal_cost(
        flow_samples, config.trainer.lnpi, config.model.sigma,
        config.model.tfinal, False,
    )
    # weights exp(-energy - terminal - stl): resample in log space
    exact, _ = is_resample(
        jax.random.PRNGKey(seed + 1), flow_samples,
        -(energy_cost + terminal + stl),
    )
    return BaselineResult(flow_samples, exact, train_time, {})


BASELINES: dict = {
    "flowmc": ("flowMC", run_flowmc),
    "fab": ("fabjax", run_fab),
    "dds": ("dds", run_dds),
}


def _fallback_fab(target, cfg, seed, **kwargs):
    from mfm_tpu.drivers.fab import fab_baseline

    kwargs.pop("config_path", None)
    return fab_baseline(target, cfg, seed=seed, **kwargs)


def _fallback_flowmc(target, cfg, seed, **kwargs):
    from mfm_tpu.drivers.flowmc import flowmc_baseline

    return flowmc_baseline(target, cfg, seed=seed, **kwargs)


def _fallback_dds(target, cfg, seed, **kwargs):
    from mfm_tpu.drivers.dds import dds_baseline

    return dds_baseline(target, cfg, seed=seed, **kwargs)


# every baseline has an in-repo implementation; the external adapter runs
# instead when its package happens to be installed (API parity with the
# reference environment)
FALLBACKS = {
    "fab": _fallback_fab,
    "flowmc": _fallback_flowmc,
    "dds": _fallback_dds,
}


def run_baseline(name: str, target: Target, cfg: MFMConfig, seed: int = 0,
                 **kwargs) -> BaselineResult:
    """Dispatch a named baseline. Every baseline always runs: the external
    package's adapter when that package is present (reference-environment
    parity), otherwise the in-repo implementation — FAB (drivers/fab.py,
    same configs/fab/ tree), flowMC (drivers/flowmc.py), DDS
    (drivers/dds.py)."""
    try:
        package, fn = BASELINES[name]
    except KeyError:
        raise ValueError(
            f"unknown baseline {name!r}; choose from {sorted(BASELINES)}"
        ) from None
    if not available(package):
        return FALLBACKS[name](target, cfg, seed, **kwargs)
    return fn(target, cfg, seed, **kwargs)
