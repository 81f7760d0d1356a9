"""The MFM training driver: interleaved MCMC / flow-refresh data generation,
on-device flow-matching training, adaptive tempering, final importance-
corrected sampling.

Algorithmic parity with the reference orchestrator
(/root/reference/exe_flow_matching.py:321-575) with the defining
accelerator-side change (SURVEY.md section 7 item 1): the reference drives training from a
host Python loop with a device round-trip every iteration (:432-449); here
the entire loop body — kernel interleave (lax.cond on the step counter),
FM gradient step, ESS-bisection tempering — is a single scanned, jitted
program. Metrics stream back in chunks of ``cfg.chunk_size`` steps.

Other deliberate redesigns:
- tempering uses the in-repo fixed-iteration bisection (no jaxopt;
  reference :391-403 uses jaxopt.Bisection)
- the final IS correction resamples in log-space with Gumbel top-k
- chain ensembles may be sharded over a mesh axis; flow params stay
  replicated and gradients reduce automatically under jit.
"""

import functools
import time
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from mfm_tpu.config import MFMConfig
from mfm_tpu.flows import (
    FlowTarget,
    apply_gradients,
    create_train_state,
    flow_matching_loss,
    make_lr_schedule,
    make_optimizer,
    make_transport,
    select_flow_kernel,
)
from mfm_tpu.flows.train import TrainState
from mfm_tpu.kernels import ChainState, mala
from mfm_tpu.targets import make_ref_dist
from mfm_tpu.targets.base import Target


class MFMCarry(NamedTuple):
    chain: ChainState
    train: TrainState
    beta: jax.Array
    # in-loop MCMC adaptation state (inert when adaptation is off): dual-
    # averaging step size, Welford mass accumulator, diagonal inverse mass.
    # Ensemble-pooled: one step size / mass for the whole chain block, fed by
    # the mean acceptance and pooled positions of all B chains per step.
    da: object = None
    wf: object = None
    inv_mass: Optional[jax.Array] = None


class MFMRun(NamedTuple):
    """Everything a caller needs after training."""

    train: TrainState
    chain: ChainState
    beta: jax.Array
    metrics: dict  # per-iteration stacked scalars
    train_time: float
    apply_fn: Callable
    transport: object
    ref_dist: Target


def ess_of(logw: jax.Array) -> jax.Array:
    """ESS = 1 / sum(normalized_w^2) (reference beta_fn, :393-399)."""
    w = jax.nn.softmax(logw)
    return 1.0 / jnp.sum(w * w)


def next_beta(prev_beta, logliks, alpha: float, n_chain: int, n_iters: int = 30):
    """Smallest beta in [prev_beta, 1] with ESS of the incremental weights
    equal to alpha * n_chain, by fixed-iteration bisection (reference
    :391-403). Saturates at 1 when even beta=1 keeps ESS above target."""
    from mfm_tpu.smc.solvers import bisection

    def gap(beta):
        return ess_of(logliks * (beta - prev_beta)) - alpha * n_chain

    return bisection(gap, prev_beta, 1.0, n_iters=n_iters)


def tempered_value_and_score(target: Target):
    """(x, beta) -> (logdensity, grad) of beta * loglik + logprior, batched.
    Delegates to the target, which may provide an analytic fused path
    (e.g. LGCP's precision-GEMM score)."""
    return target.tempered_value_and_score


def _interleave_is_flow(count, mcmc_per_flow_steps: float):
    """Reference interleaving rule (exe_flow_matching.py:304-314):
    ratio in (0, 1): one MCMC step every int(1/ratio)+1 iters (rest flow);
    ratio >= 1: one flow step every int(ratio)+1 iters (rest MCMC)."""
    if 0 < mcmc_per_flow_steps < 1:
        period = int(1.0 / mcmc_per_flow_steps) + 1
        return count % period != 0
    period = int(mcmc_per_flow_steps) + 1
    return count % period == 0


class MFMPieces(NamedTuple):
    """Everything build_mfm constructs. Access fields by attribute
    (``pieces.step_fn`` etc.) — the positional order is not a contract."""

    step_fn: Callable
    init_fn: Callable
    apply_fn: Callable
    transport: object
    ref_dist: Target
    loss_fn: Callable
    fourier: jax.Array


def field_net(target: Target, cfg: MFMConfig, fourier: jax.Array):
    """The configured CNF velocity field for ``target``."""
    from mfm_tpu.flows.vector_field import NON_LINEARITIES, VectorFieldNet

    return VectorFieldNet(
        fourier_freqs=fourier,
        hidden_x=tuple(cfg.hidden_x),
        hidden_t=tuple(cfg.hidden_t),
        hidden_xt=tuple(cfg.hidden_xt),
        act=NON_LINEARITIES[cfg.non_linearity],
        score_fn=target.score,
        score_clip=cfg.score_clip,
        precision=(
            jax.lax.Precision.HIGHEST
            if cfg.field_precision == "highest"
            else None
        ),
    )


def build_mfm(target: Target, cfg: MFMConfig, key: jax.Array) -> MFMPieces:
    """Construct the jitted pieces of an MFM run. Traceable — may be called
    inside a vmapped trace (the multi-seed driver does) since the network's
    Fourier frequencies are ordinary traced values."""

    key_net, _ = jax.random.split(key)
    key_freq, key_init = jax.random.split(key_net)
    use_real_samples = cfg.mcmc_per_flow_steps < 0

    fourier = cfg.fourier_std * jax.random.normal(key_freq, (cfg.fourier_dim,))
    net = field_net(target, cfg, fourier)
    apply_fn = net.apply
    params = net.init(key_init, cfg.dim)
    transport = make_transport(
        apply_fn, divergence=cfg.divergence, n_steps=cfg.ode_steps,
        method=cfg.ode_method,
    )
    if cfg.ref_dist == "prior":
        from mfm_tpu.targets.base import PriorReference

        ref_dist = PriorReference(target)
    else:
        ref_dist = make_ref_dist(cfg.ref_dist, cfg.dim)
    lr_fn = make_lr_schedule(cfg.learning_iter, cfg.warmup_steps, cfg.learning_rate)
    tx = make_optimizer(
        lr_fn,
        weight_decay=cfg.weight_decay,
        b1=cfg.adam_beta1,
        b2=cfg.adam_beta2,
        eps=cfg.adam_epsilon,
        gradient_clip=cfg.gradient_clip,
    )
    vs_fn = tempered_value_and_score(target)
    flow_kernel = select_flow_kernel(cfg.num_importance_samples)

    def loss_fn(p, key, samples):
        return flow_matching_loss(
            p,
            apply_fn,
            key,
            samples,
            cfg.sigma,
            ref_sampler=ref_dist.sample,
            conditional=cfg.cond_flow,
            ot_coupling=cfg.ot_cond_flow,
        )

    adapt_step, adapt_mass, target_acc = cfg.resolved_adaptation()
    adapting = adapt_step or adapt_mass

    def init_adaptation():
        if not adapting:
            return None, None, None
        from mfm_tpu.adaptation.window import da_init, welford_init

        return da_init(cfg.step_size), welford_init(cfg.dim), jnp.ones(cfg.dim)

    def init_fn(init_positions):
        """Initial carry: tempering level from the ESS rule at beta=0
        (reference :426), chains initialized at that tempered target."""
        if use_real_samples:
            beta = jnp.ones(())
        else:
            beta = next_beta(
                0.0, target.log_lik(init_positions), cfg.alpha, cfg.num_chain
            )
        vs = lambda x: vs_fn(x, beta)
        chain = mala.init(init_positions, vs)
        train = create_train_state(params, tx)
        return MFMCarry(chain, train, beta, *init_adaptation())

    # adaptation freezes after this iteration: step pinned to the averaged
    # value, mass fixed (cfg.adapt_freeze_fraction; 1.0 = adapt throughout)
    freeze_iter = int(cfg.adapt_freeze_fraction * cfg.learning_iter)

    def update_adaptation(acc, position, da, wf, inv_mass, frozen):
        """Dual-averaging step size on the ensemble-mean acceptance; Welford
        diagonal mass over pooled (iters x chains) positions, refreshed (and
        the step size re-anchored, Stan-window style) every
        cfg.mass_refresh_every MCMC steps.

        The refresh counts MCMC steps through the Welford sample count (it
        grows by num_chain per MCMC step) — NOT through the global step
        counter, which only reaches this code on MCMC iterations and can
        systematically miss every multiple of mass_refresh_every when the
        flow/MCMC interleave period divides it."""
        from mfm_tpu.adaptation.window import (
            da_init,
            da_update,
            welford_init,
            welford_update_batch,
            welford_variance,
        )

        if adapt_step:
            mean_acc = jnp.nan_to_num(jnp.mean(acc), nan=0.0)
            da_new = da_update(da, mean_acc, target_acc)
            da = jax.tree_util.tree_map(
                lambda new, old: jnp.where(frozen, old, new), da_new, da
            )
        if adapt_mass:
            wf_new = welford_update_batch(wf, position)
            wf = jax.tree_util.tree_map(
                lambda new, old: jnp.where(frozen, old, new), wf_new, wf
            )
            refresh = (
                wf.count >= cfg.mass_refresh_every * cfg.num_chain
            ) & ~frozen
            inv_mass = jnp.where(refresh, welford_variance(wf), inv_mass)
            wf = jax.tree_util.tree_map(
                lambda cur, fresh: jnp.where(refresh, fresh, cur),
                wf,
                welford_init(cfg.dim),
            )
            da_fresh = da_init(jnp.exp(da.log_step_avg))
            da = jax.tree_util.tree_map(
                lambda cur, fresh: jnp.where(refresh, fresh, cur), da, da_fresh
            )
        return da, wf, inv_mass

    def data_step(key, chain, train_params, beta, count, da, wf, inv_mass):
        """One interleaved data-generation move for the whole ensemble."""
        if use_real_samples:
            pos = target.sample(key, (cfg.num_chain,))
            new_chain = ChainState(
                pos, jnp.zeros(cfg.num_chain), jnp.zeros_like(pos)
            )
            return new_chain, jnp.full(cfg.num_chain, jnp.nan), da, wf, inv_mass

        vs = lambda x: vs_fn(x, beta)
        tgt = FlowTarget(vs, ref_dist.log_prob, ref_dist.sample)

        def do_flow(k):
            new, info = flow_kernel(k, chain, train_params, transport, tgt)
            return new, info.acceptance_rate, da, wf, inv_mass

        # counts run 1..learning_iter, so adaptation stays live through
        # iteration freeze_iter inclusive (fraction 1.0 = never frozen,
        # exactly the round-2 always-adapting behavior)
        frozen = count > freeze_iter
        step_size = (
            jnp.exp(jnp.where(frozen, da.log_step_avg, da.log_step))
            if adapt_step
            else cfg.step_size
        )
        if cfg.mcmc_kernel == "mala":
            mcmc = mala.build_kernel(vs)
            do_mcmc = lambda k: mcmc(k, chain, step_size)
        elif cfg.mcmc_kernel == "hmc":
            from mfm_tpu.kernels import hmc

            mcmc = hmc.build_kernel(vs)
            do_mcmc = lambda k: mcmc(
                k, chain, step_size, cfg.hmc_num_integration_steps, inv_mass
            )
        elif cfg.mcmc_kernel == "nuts":
            from mfm_tpu.kernels import nuts

            mcmc = nuts.build_kernel(
                vs, cfg.nuts_max_depth, variant=cfg.nuts_variant
            )
            do_mcmc = lambda k: mcmc(k, chain, step_size, inv_mass)
        else:
            raise ValueError(f"unknown mcmc_kernel {cfg.mcmc_kernel!r}")

        def do_mala(k):
            new, info = do_mcmc(k)
            new_da, new_wf, new_im = update_adaptation(
                info.acceptance_rate, new.position, da, wf, inv_mass, frozen
            )
            return new, info.acceptance_rate, new_da, new_wf, new_im

        return lax.cond(
            _interleave_is_flow(count, cfg.mcmc_per_flow_steps), do_flow, do_mala, key
        )

    def temper_step(chain, beta):
        """ESS-bisection tempering + chain re-init at the new level
        (reference beta_gen, :410-417)."""
        new_beta = next_beta(
            beta, target.log_lik(chain.position), cfg.alpha, cfg.num_chain
        )
        vs = lambda x: vs_fn(x, new_beta)
        new_chain = mala.init(chain.position, vs)
        return new_chain, new_beta

    def step_fn(carry: MFMCarry, xs):
        key, count = xs
        k_gen, k_loss = jax.random.split(key)

        chain, acc, da, wf, inv_mass = data_step(
            k_gen, carry.chain, carry.train.params, carry.beta, count,
            carry.da, carry.wf, carry.inv_mass,
        )

        loss, grads = jax.value_and_grad(loss_fn)(
            carry.train.params, k_loss, chain.position
        )
        train = apply_gradients(carry.train, grads, tx)

        if use_real_samples:
            beta = carry.beta
        else:
            do_temper = (count % cfg.iter_per_temp == 0) & (carry.beta < 1.0)
            chain, beta = lax.cond(
                do_temper,
                lambda args: temper_step(*args),
                lambda args: (args[0], args[1]),
                (chain, carry.beta),
            )

        metrics = {
            "loss": loss,
            "learning_rate": lr_fn(carry.train.step),
            "acceptance_mean": jnp.nanmean(acc),
            "acceptance_std": jnp.nanstd(acc),
            "beta": beta,
        }
        if adapt_step:
            # the step the kernel actually used this iteration (pinned to
            # the dual-averaged value once the freeze kicks in)
            metrics["step_size"] = jnp.exp(
                jnp.where(count > freeze_iter, da.log_step_avg, da.log_step)
            )
        return MFMCarry(chain, train, beta, da, wf, inv_mass), metrics

    return MFMPieces(
        step_fn=step_fn,
        init_fn=init_fn,
        apply_fn=apply_fn,
        transport=transport,
        ref_dist=ref_dist,
        loss_fn=loss_fn,
        fourier=fourier,
    )


def keep_chains_sharded(step_fn: Callable, chain_sharding) -> Callable:
    """``step_fn`` whose output chain state keeps ``chain_sharding`` (a
    pytree of shardings shaped like ``MFMCarry.chain``). Without the
    constraint XLA's sharding propagation is free to replicate the whole
    ensemble on every device, which four H100s did."""

    def step(carry: MFMCarry, xs):
        carry, metrics = step_fn(carry, xs)
        chain = jax.lax.with_sharding_constraint(carry.chain, chain_sharding)
        return carry._replace(chain=chain), metrics

    return step


def run_mfm(
    target: Target,
    cfg: MFMConfig,
    logger=None,
    key: Optional[jax.Array] = None,
) -> MFMRun:
    """Train an MFM sampler; the loop runs on device in chunks.

    ``logger`` (optional) gets ``log(dict)`` called once per chunk with the
    chunk-mean metrics.
    """
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    key_build, key_pos, key_loop = jax.random.split(key, 3)

    pieces = build_mfm(target, cfg, key_build)
    step_fn = pieces.step_fn
    init_fn = pieces.init_fn
    apply_fn = pieces.apply_fn
    transport = pieces.transport
    ref_dist = pieces.ref_dist
    loss_fn = pieces.loss_fn
    init_positions = target.init_positions(key_pos, cfg.num_chain)

    carry = jax.jit(init_fn)(init_positions)

    mesh = None
    if cfg.mesh_shape is not None:
        from mfm_tpu.parallel import make_mesh, replicate, shard_chains

        axis_names = ("ensemble", "chains")[-len(cfg.mesh_shape) :]
        mesh = make_mesh(tuple(cfg.mesh_shape), axis_names)
        carry = carry._replace(
            chain=shard_chains(carry.chain, mesh),
            train=replicate(carry.train, mesh),
            beta=replicate(carry.beta, mesh),
            da=replicate(carry.da, mesh),
            wf=replicate(carry.wf, mesh),
            inv_mass=replicate(carry.inv_mass, mesh),
        )
        step_fn = keep_chains_sharded(
            step_fn, jax.tree_util.tree_map(lambda a: a.sharding, carry.chain)
        )

    # the incoming carry is dead after each chunk: donating it lets XLA
    # reuse the chain/optimizer buffers in place instead of allocating a
    # fresh output set per chunk (device-memory traffic + footprint)
    @functools.partial(jax.jit, donate_argnums=0)
    def run_chunk(carry, keys, counts):
        return lax.scan(step_fn, carry, (keys, counts))

    n_iter = cfg.learning_iter
    chunk = max(1, min(cfg.chunk_size, n_iter))
    all_keys = jax.random.split(key_loop, n_iter)
    counts = jnp.arange(1, n_iter + 1)

    # target-loss probe: FM loss on exact target draws, logged per chunk
    # (the reference's eval_step computes it per iteration,
    # exe_flow_matching.py:370-374,444-446)
    eval_loss = None
    if logger is not None and target.can_sample:
        key_probe, key_probe_loss = jax.random.split(jax.random.fold_in(key, 7))
        n_probe = min(cfg.eval_iter * cfg.num_chain, 4096)
        probe_samples = target.sample(key_probe, (n_probe,))
        eval_loss = jax.jit(
            lambda params: loss_fn(params, key_probe_loss, probe_samples)
        )

    # resume from the latest checkpoint when one exists. The carry is
    # saved/restored sharded (utils/checkpoint.py handles multi-process
    # orbax), so this works under a multi-controller mesh too: every
    # process reaches these collective calls on the same chunk schedule.
    done = 0
    if cfg.checkpoint_dir is not None:
        from mfm_tpu.utils.checkpoint import restore_checkpoint

        restored, ckpt_step = restore_checkpoint(
            cfg.checkpoint_dir, template=carry
        )
        if restored is not None:
            carry = MFMCarry(*restored) if not isinstance(restored, MFMCarry) else restored
            done = int(ckpt_step)

    # Warm-compile the chunk program so train_time measures steady-state
    # throughput. (The reference's "post jit" timer, exe_flow_matching.py:421,
    # still pays first-call compilation inside the loop.)
    jax.block_until_ready(carry)
    if done < n_iter:
        first = min(chunk, n_iter - done)
        # warm on a copy: run_chunk donates its carry argument, and the
        # real loop below must still start from the original state
        warm_carry = jax.tree_util.tree_map(
            lambda x: jnp.copy(x) if hasattr(x, "dtype") else x, carry
        )
        warm = run_chunk(
            warm_carry, all_keys[done : done + first], counts[done : done + first]
        )
        jax.block_until_ready(warm)  # populates the jit cache; result unused
    metrics_chunks = []
    train_start = time.time()
    chunks_done = 0
    while done < n_iter:
        take = min(chunk, n_iter - done)
        carry, m = run_chunk(
            carry, all_keys[done : done + take], counts[done : done + take]
        )
        metrics_chunks.append(m)
        done += take
        chunks_done += 1
        if logger is not None:
            chunk_mean = {k: float(jnp.mean(v)) for k, v in m.items()}
            chunk_mean["iter"] = done
            chunk_mean["train_time"] = time.time() - train_start
            if eval_loss is not None:
                chunk_mean["target_loss"] = float(eval_loss(carry.train.params))
            logger.log(chunk_mean)
        if (
            cfg.checkpoint_dir is not None
            and cfg.checkpoint_every_chunks
            and chunks_done % cfg.checkpoint_every_chunks == 0
        ):
            from mfm_tpu.utils.checkpoint import save_checkpoint

            save_checkpoint(cfg.checkpoint_dir, done, carry)
    jax.block_until_ready(carry)
    train_time = time.time() - train_start

    if metrics_chunks:
        metrics = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs), *metrics_chunks
        )
    else:
        # resumed at (or past) learning_iter: nothing left to run
        metrics = {}

    # evaluation-facing transport: richer divergence probes / finer ODE grid
    # than the training loop's (IS weights exponentiate logdet noise)
    if (
        cfg.eval_hutchinson_probes != 1
        or cfg.eval_probe_dist != "gaussian"
        or cfg.eval_ode_steps is not None
    ):
        transport = make_transport(
            apply_fn,
            divergence=cfg.divergence,
            n_steps=cfg.eval_ode_steps or cfg.ode_steps,
            method=cfg.ode_method,
            num_probes=cfg.eval_hutchinson_probes,
            probe_dist=cfg.eval_probe_dist,
        )

    return MFMRun(
        carry.train,
        carry.chain,
        carry.beta,
        metrics,
        train_time,
        apply_fn,
        transport,
        ref_dist,
    )


def sample_flow_parts(
    transport,
    params,
    ref_dist: Target,
    key: jax.Array,
    n_samples: int,
    target: Target,
):
    """Final sampling + self-normalized IS correction
    (reference exe_flow_matching.py:453-459).

    Returns (flow_samples, exact_samples, log_weights).
    """
    from mfm_tpu.drivers.baselines import is_resample

    key_ref, key_hutch, key_choice = jax.random.split(key, 3)
    u = ref_dist.sample(key_ref, (n_samples,))
    flow_samples, logdet = transport.forward(params, u, key_hutch)
    logpdf = target.log_prob(flow_samples)
    log_q = ref_dist.log_prob(u) - logdet
    # log-space categorical resampling, one shared sanitization rule with
    # the baseline adapters (the reference exponentiates weights first,
    # :458, which under/overflows in f32)
    exact_samples, log_w = is_resample(key_choice, flow_samples, logpdf, log_q)
    return flow_samples, exact_samples, log_w


def sample_flow(run: MFMRun, key: jax.Array, n_samples: int, target: Target):
    return sample_flow_parts(
        run.transport, run.train.params, run.ref_dist, key, n_samples, target
    )


def sample_flow_defensive_parts(
    transport,
    params,
    ref_dist: Target,
    key: jax.Array,
    n_samples: int,
    target: Target,
    defensive_dist: Target,
    alpha: float = 0.9,
):
    """Defensive-mixture IS correction: propose from
    ``q_mix = a*q_flow + (1-a)*q_def`` instead of the flow alone.

    The round-5 many-well mechanism result (RESULTS.md "the many-well
    -1.2-nat logZ loop, closed") isolated the one-shot estimator's logZ
    deficit as a finite-N tilt under heavy-tailed pullback weights: where
    the flow underweights a mode, ``pi/q_flow`` explodes and
    ``logsumexp(log w) - log N`` undershoots until N covers the tail.
    Mixing in a wide defensive component (Hesterberg 1995) bounds every
    weight at ``pi(x) / ((1-a) q_def(x))``, removing the tail by
    construction rather than by sample count. No reference counterpart
    (the reference's final-IS block, exe_flow_matching.py:453-459, is the
    pure-flow ``alpha=1`` special case).

    Sampling is deterministically stratified — ``round((1-alpha) n)``
    draws from the defensive component, the rest through the flow (static
    shapes under jit) — and the mixture density uses the realized
    fractions, which keeps the balance-heuristic estimator unbiased under
    the rounding. Flow density at defensive points comes from one extra
    ``transport.inverse`` pass on the (small) defensive batch.

    Returns (mixture_samples, exact_samples, log_weights).
    """
    from mfm_tpu.drivers.baselines import is_resample

    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    n_def = int(round((1.0 - alpha) * n_samples))
    if n_def == 0:
        return sample_flow_parts(
            transport, params, ref_dist, key, n_samples, target
        )
    n_flow = n_samples - n_def
    k_ref, k_fwd, k_def, k_inv, k_choice = jax.random.split(key, 5)

    u = ref_dist.sample(k_ref, (n_flow,))
    x_f, logdet_f = transport.forward(params, u, k_fwd)
    log_qf_f = ref_dist.log_prob(u) - logdet_f

    x_d = defensive_dist.sample(k_def, (n_def,))
    u_d, logdet_d = transport.inverse(params, x_d, k_inv)
    log_qf_d = ref_dist.log_prob(u_d) - logdet_d

    x = jnp.concatenate([x_f, x_d], axis=0)
    log_qf = jnp.concatenate([log_qf_f, log_qf_d], axis=0)
    log_qd = defensive_dist.log_prob(x)

    a_real = n_flow / n_samples  # realized fraction, not the nominal alpha
    log_qmix = jnp.logaddexp(
        jnp.log(a_real) + log_qf, jnp.log1p(-a_real) + log_qd
    )
    logpdf = target.log_prob(x)
    exact_samples, log_w = is_resample(k_choice, x, logpdf, log_qmix)
    return x, exact_samples, log_w


def sample_flow_defensive(
    run: MFMRun,
    key: jax.Array,
    n_samples: int,
    target: Target,
    defensive_dist: Target,
    alpha: float = 0.9,
):
    return sample_flow_defensive_parts(
        run.transport,
        run.train.params,
        run.ref_dist,
        key,
        n_samples,
        target,
        defensive_dist,
        alpha,
    )


def sample_flow_move(
    run: MFMRun,
    key: jax.Array,
    n_samples: int,
    target: Target,
    n_moves: int = 100,
    init_step: float = 0.01,
    target_acceptance: float = 0.574,
):
    """Move-corrected flow sampling: IS resample, then ``n_moves`` MALA
    steps on the exact target with dual-averaging step-size adaptation.

    At high dim the raw importance weights are irreducibly heavy-tailed
    (log-weight spread grows ~ per-dim flow error x d; measured ~12 nats on
    pines d=1600, benchmarks/pines_is_ess.py), so self-normalized IS alone
    collapses to a handful of effective samples — for the reference too
    (RESULTS.md r1 parity). The MCMC move kernel repairs exactly this: the
    resampled set starts in the typical set of pi and the moves restore
    diversity, giving chain-quality posterior samples at a bounded extra
    cost. New capability beyond the reference's final-IS block
    (exe_flow_matching.py:453-459). Measured on pines d=1600: KSD-U 2813 ->
    0.048 (RESULTS.md round 2).

    Caveat: local moves repair within-mode degeneracy; on strongly
    multimodal targets the resampled ancestors must already cover the modes
    (the trained flow provides that on the benchmark mixtures).

    Returns (moved_samples, exact_samples, log_weights).
    """
    key_is, key_moves = jax.random.split(key)
    flow_s, exact_s, log_w = sample_flow(run, key_is, n_samples, target)
    moved = mala_move_correct(
        exact_s, target, key_moves, n_moves, init_step, target_acceptance
    )
    return moved, exact_s, log_w


def mala_move_correct(
    positions: jax.Array,
    target: Target,
    key: jax.Array,
    n_moves: int = 100,
    init_step: float = 0.01,
    target_acceptance: float = 0.574,
) -> jax.Array:
    """Self-tuning MALA move correction of an approximate sample set.

    Continuous adaptation breaks detailed balance, so the chain is split
    into a warmup half (dual-averaging live) and a sampling half run at
    the frozen averaged step size exp(log_step_avg) — only the frozen
    half's endpoint is returned, so the final kernel is exactly
    target-invariant. Shared by ``sample_flow_move`` and the CLI's
    ``--flow-smc N --move-correct M`` composition.
    """
    from mfm_tpu.adaptation.window import da_init, da_update

    vs = target.value_and_score
    kernel = mala.build_kernel(vs)
    n_warm = n_moves // 2

    @jax.jit
    def run_moves(positions, key):
        state = mala.init(positions, vs)

        def warm_body(carry, k):
            state, da = carry
            new_state, info = kernel(k, state, jnp.exp(da.log_step))
            da = da_update(
                da,
                jnp.nan_to_num(jnp.mean(info.acceptance_rate), nan=0.0),
                target_acceptance,
            )
            return (new_state, da), None

        keys = jax.random.split(key, n_moves)
        (state, da), _ = lax.scan(
            warm_body, (state, da_init(init_step)), keys[:n_warm]
        )
        frozen_step = jnp.exp(da.log_step_avg)

        def frozen_body(state, k):
            new_state, _ = kernel(k, state, frozen_step)
            return new_state, None

        state, _ = lax.scan(frozen_body, state, keys[n_warm:])
        return state.position

    return run_moves(positions, key)
