"""Run the MFM main path once on an NVIDIA GPU and check what comes out.

    python chip_smoke.py              # one GPU: every single-card phase
    python chip_smoke.py --four-gpus  # four GPUs of one host: the sharded phase only

Phases (one JSON line each, in order): the device; MFM training, final IS
sampling and the metric row on pines (d=1600) and phi-four (d=64) at their
preset widths, and on 4-mode at the reference's 12,800-sample eval size;
the pines target and the pines-width CNF transport against the same
computation on the host CPU. ``--four-gpus`` instead runs phi-four with its
chain ensemble sharded over four cards against the same step on one card,
the distributed systematic resampler against the single-device one, and
flow-annealed SMC under the mesh.

Every phase raises on a failed check and nothing catches it, so the
process exits non-zero. Only when every phase passed does the last line of
standard output read ``{"ok": true, "device": {...}}``. Times and rates
are information, printed beside the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

T_EVAL = 12_800  # the reference's eval size: eval_iter 100 x 128 chains


def emit(phase: str, **record) -> None:
    print(json.dumps({"phase": phase, **record}, default=float), flush=True)


def require_gpu(count: int = 1) -> None:
    """Stop unless JAX's default backend is a GPU with ``count`` devices."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"chip_smoke needs an NVIDIA GPU; JAX's default backend is {backend!r}"
        )
    if len(jax.devices()) < count:
        raise SystemExit(
            f"chip_smoke needs {count} GPUs; JAX sees {len(jax.devices())}"
        )


def card() -> list:
    """One 'name, power limit' line per card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


def _finite_floats(metrics: dict) -> dict:
    floats = {k: v for k, v in metrics.items() if isinstance(v, float)}
    bad = {k: v for k, v in floats.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f"non-finite metrics: {bad}")
    return floats


def phase_device(cache_dir: str) -> None:
    import jax

    dev = jax.devices()[0]
    emit(
        "device", platform=dev.platform, device_kind=dev.device_kind,
        count=len(jax.devices()), jax=jax.__version__,
        xla_flags=os.environ.get("XLA_FLAGS", ""), compile_cache=cache_dir,
        card=card(),
    )


def run_example(example: str, phase: str, **overrides):
    """Train, sample and evaluate one preset through the library calls the
    CLI makes (cli.run_one); return (run, cfg, target, samples, metrics)."""
    import jax

    from mfm_tpu.cli import make_target
    from mfm_tpu.config import preset
    from mfm_tpu.drivers import evaluate_samples, run_mfm, sample_flow
    from mfm_tpu.drivers.mfm import _interleave_is_flow

    cfg = preset(example, seed=0, **overrides)
    target = make_target(example)
    t0 = time.perf_counter()
    run = run_mfm(target, cfg)
    wall_train = time.perf_counter() - t0

    key = jax.random.PRNGKey(cfg.seed)
    n_eval = cfg.eval_iter * cfg.num_chain
    real = None
    if target.can_sample:
        real = target.sample(jax.random.fold_in(key, 1000), (n_eval,))
    t0 = time.perf_counter()
    flow, exact, _ = sample_flow(run, jax.random.fold_in(key, 999), n_eval, target)
    metrics = evaluate_samples(target, flow, exact, real)
    wall_eval = time.perf_counter() - t0

    acc = np.asarray(run.metrics["acceptance_mean"])
    is_flow = np.array([
        bool(_interleave_is_flow(c, cfg.mcmc_per_flow_steps))
        for c in range(1, cfg.learning_iter + 1)
    ])
    mala_acc = float(np.nanmean(acc[~is_flow]))
    flow_acc = float(np.nanmean(acc[is_flow])) if is_flow.any() else None
    if not 0.0 < mala_acc < 1.0:
        raise AssertionError(f"{phase}: MALA acceptance {mala_acc} not in (0, 1)")
    if is_flow.sum() < 2 and cfg.mcmc_per_flow_steps > 1:
        raise AssertionError(f"{phase}: fewer than two flow steps ran")
    loss = np.asarray(run.metrics["loss"])
    if not np.isfinite(loss).all():
        raise AssertionError(f"{phase}: non-finite training loss")
    emit(
        phase, dim=cfg.dim, num_chain=cfg.num_chain,
        learning_iter=cfg.learning_iter, field_precision=cfg.field_precision,
        flow_steps=int(is_flow.sum()), mala_acceptance=mala_acc,
        flow_acceptance=flow_acc, final_loss=float(loss[-1]),
        metrics=_finite_floats(metrics),
        iters_per_s=cfg.learning_iter / run.train_time,
        train_time_s=run.train_time, train_wall_incl_compile_s=wall_train,
        eval_wall_incl_compile_s=wall_eval, n_eval=n_eval, card=card(),
    )
    return run, cfg, target, (flow, exact, real), metrics


def phase_phi_four_field(run, cfg, target) -> None:
    """What XLA makes of the phi-four field at the preset's 1024 chains:
    one RK4 stage's field work (the apply plus the exact divergence, d
    scanned x-JVPs), against one flow step and one MALA step of the MFM
    loop. A flow-MH step runs two transports of ode_steps x 4 stages. The
    stage is timed on its own and pays a dispatch that the scanned step
    does not, so the field shares are upper estimates."""
    import jax
    import jax.numpy as jnp

    from mfm_tpu.drivers.mfm import build_mfm
    from mfm_tpu.flows import exact_divergence
    from mfm_tpu.utils.profiling import timed

    key = jax.random.PRNGKey(3)
    x = target.init_positions(key, cfg.num_chain)
    t = jnp.full((cfg.num_chain,), 0.5)
    apply_fn, params = run.apply_fn, run.train.params
    div = exact_divergence(apply_fn)
    stage = jax.jit(lambda p, x: (apply_fn(p, x, t), div(p, x, t)))
    t_stage, _ = timed(stage, params, x)

    pieces = build_mfm(target, cfg, key)
    carry = jax.jit(pieces.init_fn)(x)
    step = jax.jit(lambda c, k, n: pieces.step_fn(c, (k, n)))
    period = int(cfg.mcmc_per_flow_steps) + 1
    t_flow, _ = timed(step, carry, key, jnp.asarray(period))
    t_mala, _ = timed(step, carry, key, jnp.asarray(1))
    stages = 2 * cfg.ode_steps * 4
    mean_step = (t_flow + (period - 1) * t_mala) / period
    emit(
        "phi_four_field", num_chain=cfg.num_chain,
        field_stage_ms=t_stage * 1e3, stages_per_flow_step=stages,
        flow_step_ms=t_flow * 1e3, mala_step_ms=t_mala * 1e3,
        mean_step_ms=mean_step * 1e3,
        field_share_of_flow_step=stages * t_stage / t_flow,
        field_share_of_mean_step=stages * t_stage / period / mean_step,
        card=card(),
    )


def phase_four_mode() -> None:
    """4-mode at the reference's eval size, its metric row on the XLA tiles."""
    _, _, _, (flow, _, _), _ = run_example("4-mode", "four_mode")
    if flow.shape[0] != T_EVAL:
        raise AssertionError(f"4-mode eval size {flow.shape[0]} != {T_EVAL}")


def phase_numerics() -> None:
    """The pines target and the pines-width CNF transport on the GPU
    against the same computation on the host CPU."""
    import jax

    from mfm_tpu.cli import make_target
    from mfm_tpu.config import preset
    from mfm_tpu.drivers.mfm import field_net
    from mfm_tpu.flows import make_transport

    cpu, gpu = jax.devices("cpu")[0], jax.devices()[0]

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    # each side computes under its own default device on committed inputs
    with jax.default_device(cpu):
        target_cpu = make_target("pines")
        x = jax.device_put(
            0.5 * jax.random.normal(jax.random.PRNGKey(5), (128, 1600)), cpu
        )
        lp_c = np.asarray(jax.jit(target_cpu.log_prob)(x))
        sc_c = np.asarray(jax.jit(target_cpu.score)(x))
    target_gpu = make_target("pines")
    x_gpu = jax.device_put(x, gpu)
    lp_g = np.asarray(jax.jit(target_gpu.log_prob)(x_gpu))
    sc_g = np.asarray(jax.jit(target_gpu.score)(x_gpu))
    if x.devices() != {cpu} or x_gpu.devices() != {gpu}:
        raise AssertionError("numerics inputs not on the intended devices")
    np.testing.assert_allclose(lp_g, lp_c, rtol=1e-5)
    score_rel = rel(sc_g, sc_c)
    if score_rel > 1e-5:
        raise AssertionError(f"pines score off the CPU by {score_rel}")
    emit("numerics_target", log_prob_max_rel_err=float(np.max(np.abs(lp_g - lp_c) / np.abs(lp_c))),
         score_rel_err=score_rel)

    # pines-width field, random non-zero parameters, shared Rademacher probes
    def transport_on(device, precision, params, freqs, u):
        with jax.default_device(device):
            tgt = target_cpu if device == cpu else target_gpu
            cfg = preset("pines", field_precision=precision)
            net = field_net(tgt, cfg, jax.device_put(freqs, device))
            tr = make_transport(
                net.apply, "hutchinson", n_steps=cfg.ode_steps,
                probe_dist="rademacher",
            )
            fwd = jax.jit(tr.forward)
            return [np.asarray(a) for a in fwd(
                jax.device_put(params, device), jax.device_put(u, device),
                jax.device_put(jax.random.PRNGKey(9), device),
            )]

    with jax.default_device(cpu):
        cfg = preset("pines")
        k_f, k_p, k_u = jax.random.split(jax.random.PRNGKey(7), 3)
        freqs = cfg.fourier_std * jax.random.normal(k_f, (cfg.fourier_dim,))
        params = field_net(target_cpu, cfg, freqs).init(k_p, cfg.dim)
        leaves, tree = jax.tree_util.tree_flatten(params)
        keys = jax.random.split(k_p, len(leaves))
        params = jax.tree_util.tree_unflatten(tree, [
            0.5 * jax.random.normal(k, leaf.shape) / np.sqrt(leaf.shape[0])
            for k, leaf in zip(keys, leaves)
        ])
        u = target_cpu.init_positions(k_u, 128)
    x_c, ld_c = transport_on(cpu, "highest", params, freqs, u)
    x_h, ld_h = transport_on(gpu, "highest", params, freqs, u)
    x_d, ld_d = transport_on(gpu, "default", params, freqs, u)
    rec = {
        "highest_pos_rel_err": rel(x_h, x_c),
        "highest_logdet_max_abs_err": float(np.max(np.abs(ld_h - ld_c))),
        "default_pos_rel_err": rel(x_d, x_c),
        "default_logdet_max_abs_err": float(np.max(np.abs(ld_d - ld_c))),
        "logdet_scale": float(np.max(np.abs(ld_c))),
    }
    if not (np.isfinite(x_c).all() and np.isfinite(ld_c).all()):
        raise AssertionError("CPU transport not finite")
    if rec["highest_pos_rel_err"] > 1e-4 or rec["highest_logdet_max_abs_err"] > 1e-2:
        raise AssertionError(f"pines transport off the CPU at 'highest': {rec}")
    emit("numerics_transport", **rec)


def phase_four_gpus(n_chain: int = 4096, n_iter: int = 200,
                    n_particles: int = 2**17) -> None:
    """Phi-four with its chains sharded over four cards against one card;
    the distributed systematic resampler; flow-annealed SMC under the mesh."""
    import jax
    import jax.numpy as jnp

    from mfm_tpu.cli import make_target
    from mfm_tpu.config import preset
    from mfm_tpu.drivers import run_mfm
    from mfm_tpu.drivers.flow_smc import run_flow_smc
    from mfm_tpu.drivers.mfm import build_mfm, keep_chains_sharded
    from mfm_tpu.parallel import make_mesh, replicate, shard_chains

    devices = jax.devices()[:4]
    target = make_target("phi-four")
    cfg = preset(
        "phi-four", seed=0, num_chain=n_chain, learning_iter=n_iter,
        field_precision="highest", mcmc_per_flow_steps=100.0,
    )
    key = jax.random.PRNGKey(0)
    pieces = build_mfm(target, cfg, key)
    carry0 = jax.jit(pieces.init_fn)(target.init_positions(key, n_chain))
    step = jax.jit(lambda c, k, n: pieces.step_fn(c, (k, n)))
    k_step = jax.random.PRNGKey(1)
    k_loss = jax.random.split(k_step)[1]
    grad_fn = jax.jit(jax.grad(pieces.loss_fn))

    one, m_one = step(carry0, k_step, jnp.asarray(1))
    g_one = grad_fn(carry0.train.params, k_loss, one.chain.position)

    mesh = make_mesh((1, 4), ("ensemble", "chains"), devices)
    carry_s = carry0._replace(
        chain=shard_chains(carry0.chain, mesh),
        train=replicate(carry0.train, mesh),
        beta=replicate(carry0.beta, mesh),
    )
    step_s = jax.jit(lambda c, k, n: keep_chains_sharded(
        pieces.step_fn, jax.tree_util.tree_map(lambda a: a.sharding, carry_s.chain)
    )(c, (k, n)))
    with mesh:
        sh, m_sh = step_s(carry_s, k_step, jnp.asarray(1))
        g_sh = grad_fn(carry_s.train.params, k_loss, sh.chain.position)
        jax.block_until_ready(sh)

    loss_one, loss_sh = float(m_one["loss"]), float(m_sh["loss"])
    np.testing.assert_allclose(loss_sh, loss_one, rtol=1e-5)
    flat = lambda tree: np.concatenate(
        [np.asarray(a, np.float64).ravel() for a in jax.tree_util.tree_leaves(tree)]
    )
    g1, gs = flat(g_one), flat(g_sh)
    grad_rel = float(np.linalg.norm(gs - g1) / np.linalg.norm(g1))
    if grad_rel > 1e-5:
        raise AssertionError(f"sharded gradient off one card by {grad_rel}")
    # Adam's first update is lr * g / |g| per element, so an element whose
    # gradient sits at the f32 noise of a 4096-chain sum (the two runs add
    # the chains in another order) may step the other way; every other
    # element must agree to rtol 1e-5
    p1, ps = flat(one.train.params), flat(sh.train.params)
    off = ~np.isclose(ps, p1, rtol=1e-5, atol=0.0)
    noise = 1e-4 * np.max(np.abs(g1))
    if (off & (np.abs(g1) > noise)).any():
        raise AssertionError(
            f"{int(off.sum())} parameters off one card, "
            f"{int((off & (np.abs(g1) > noise)).sum())} with a resolved gradient"
        )
    def check_quarters(position, where):
        shards = position.addressable_shards
        rows = sorted(s.data.shape[0] for s in shards)
        if rows != [n_chain // 4] * 4 or len({s.device for s in shards}) != 4:
            raise AssertionError(
                f"{where}: chain state not split in quarters over four cards "
                f"(rows per shard {rows})"
            )

    check_quarters(sh.chain.position, "one sharded step")
    in_use = [d.memory_stats()["bytes_in_use"] for d in devices]
    if min(in_use) <= 0:
        raise AssertionError(f"a card holds nothing: {in_use}")
    pos_rel = float(np.linalg.norm(np.asarray(sh.chain.position) - np.asarray(one.chain.position))
                    / np.linalg.norm(np.asarray(one.chain.position)))
    emit("four_gpu_step", loss_one=loss_one, loss_sharded=loss_sh,
         grad_rel_err=grad_rel, params_off=int(off.sum()),
         chain_position_rel_err=pos_rel, bytes_in_use=in_use, card=card())

    cfg_mesh = preset(
        "phi-four", seed=0, num_chain=n_chain, learning_iter=n_iter,
        field_precision="highest", mcmc_per_flow_steps=100.0, mesh_shape=(1, 4),
    )
    run = run_mfm(target, cfg_mesh)
    loss = np.asarray(run.metrics["loss"])
    if not np.isfinite(loss).all() or not np.isfinite(np.asarray(run.chain.position)).all():
        raise AssertionError("sharded 200-iteration run not finite")
    check_quarters(run.chain.position, "sharded run_mfm")
    emit("four_gpu_run", learning_iter=n_iter, num_chain=n_chain,
         iters_per_s=n_iter / run.train_time, final_loss=float(loss[-1]), card=card())

    emit("four_gpu_resample", **check_distributed_resampler(devices, n_particles))

    params = replicate(run.train.params, mesh)
    with mesh:
        res = run_flow_smc(
            target, cfg_mesh, run.transport, params, run.ref_dist,
            key=jax.random.PRNGKey(3), n_particles=n_chain, n_steps=2,
            num_mcmc_steps=1,
        )
        jax.block_until_ready(res.samples)
    if not np.isfinite(float(res.log_z)) or res.samples.shape != (n_chain, cfg.dim):
        raise AssertionError(f"flow-SMC under the mesh: log_z {res.log_z}")
    emit("four_gpu_flow_smc", log_z=float(res.log_z), lmbda=float(res.lmbda),
         n_particles=n_chain)


def check_distributed_resampler(devices, n_particles: int) -> dict:
    """The distributed systematic resampler over ``devices`` against the
    single-device one, on the same f32 weights and uniform.

    The two bracket the cumulative weights in another order: one global
    cumulative sum, or per-shard sums plus sequential shard offsets. A slot
    whose grid point lies within both sums' rounding may take another
    ancestor, and the two ancestors then lie as far apart as there are
    particles whose whole weight fits in that rounding. Each bracket is off
    the exact cumulative weight by at most its own sum's rounding, so the
    weight strictly between the two ancestors is at most the two roundings
    added. Any larger difference is a fault."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mfm_tpu.parallel import make_mesh
    from mfm_tpu.smc.distributed import distributed_systematic
    from mfm_tpu.smc.resampling import systematic

    n_shards = len(devices)
    mesh = make_mesh((n_shards,), ("chains",), devices)
    k_w, k_r = jax.random.split(jax.random.PRNGKey(2))
    w = jax.nn.softmax(2.0 * jax.random.normal(k_w, (n_particles,)))
    ref = np.asarray(jax.jit(lambda k, w: systematic(k, w, n_particles))(k_r, w))
    w_s = jax.device_put(w, NamedSharding(mesh, P("chains")))
    got = np.asarray(jax.jit(
        lambda k, w: distributed_systematic(k, w, n_particles, mesh)
    )(k_r, w_s))
    diff = ref != got

    c64 = np.cumsum(np.asarray(w, np.float64))
    c_one = np.asarray(jax.jit(jnp.cumsum)(w))
    c_shard = np.asarray(jax.jit(lambda w: jnp.cumsum(w.reshape(n_shards, -1), 1))(w))
    offsets = np.zeros(n_shards, np.float32)
    for s in range(1, n_shards):  # f32, in the resampler's sequential order
        offsets[s] = offsets[s - 1] + c_shard[s - 1, -1]
    c_dist = (offsets[:, None] + c_shard).ravel()
    rounding = (float(np.max(np.abs(c_one - c64)))
                + float(np.max(np.abs(c_dist - c64))))
    lo, hi = np.minimum(ref, got)[diff], np.maximum(ref, got)[diff]
    between = c64[hi - 1] - c64[lo]  # weight strictly between the two
    if diff.mean() > 0.01 or (between > rounding).any():
        raise AssertionError(
            f"distributed resampler: {diff.mean():.4%} of slots differ, "
            f"weight between differing ancestors up to {between.max():.3g} "
            f"against cumulative-sum rounding {rounding:.3g}"
        )
    return dict(
        n_particles=n_particles, shards=n_shards,
        slots_differing=int(diff.sum()), fraction=float(diff.mean()),
        largest_index_difference=int(np.abs(ref - got).max()),
        cumsum_rounding=rounding,
        largest_weight_between=float(between.max()) if diff.any() else 0.0,
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the four-card phase (needs four GPUs)")
    args = p.parse_args(argv)

    require_gpu(4 if args.four_gpus else 1)
    import jax

    from mfm_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()

    phase_device(cache_dir)
    if args.four_gpus:
        phase_four_gpus()
    else:
        run_example("pines", "pines", learning_iter=300, mcmc_per_flow_steps=100.0)
        run, cfg, target, _, _ = run_example(
            "phi-four", "phi_four", learning_iter=300, mcmc_per_flow_steps=100.0
        )
        phase_phi_four_field(run, cfg, target)
        run_example(
            "phi-four", "phi_four_highest", learning_iter=300,
            mcmc_per_flow_steps=100.0, field_precision="highest",
        )
        phase_four_mode()
        phase_numerics()
    dev = jax.devices()[0]
    for line in card():
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main(sys.argv[1:])
