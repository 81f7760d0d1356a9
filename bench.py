"""Benchmark driver. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline: end-to-end MFM training throughput (iters/sec, median of 3
steady-state repeats) on the hardest reference benchmark — pines (LGCP,
d=1600, n_chain=128, mcmc_per_flow_steps=100, Hutchinson divergence;
reference README.md:54-65, multi_modal.py:87-98): a 1600x1600 precision
GEMM per MALA gradient and a 1024-wide CNF field.

vs_baseline divides by the measured steady-state rate of the UNMODIFIED
reference on a CPU host (benchmarks/reference_pines_cpu.json).

Secondary numbers (4-mode scan-vs-host-loop, phi-four ensemble MALA
chain-steps/sec, phi-four/4-mode MFM rates) go to BENCH_DETAILS.json. Each
bench runs in its own child process, one after another, so only one
process holds the accelerator at a time.
"""

import json
import os
import statistics
import time

import jax
import jax.numpy as jnp


def _time_it(fn, *args, repeats=1):
    out = jax.block_until_ready(fn(*args))
    start = time.time()
    for _ in range(repeats):
        out = jax.block_until_ready(fn(*args))
    return (time.time() - start) / repeats, out


def bench_mfm_4mode(n_iter=300):
    from mfm_tpu.config import MFMConfig
    from mfm_tpu.drivers.mfm import build_mfm
    from mfm_tpu.targets import four_mode_mixture

    target = four_mode_mixture()
    cfg = MFMConfig(
        example="4-mode", dim=2, num_chain=128, learning_iter=n_iter,
        step_size=0.2, mcmc_per_flow_steps=10.0, ode_steps=24,
    )
    key = jax.random.PRNGKey(0)
    pieces = build_mfm(target, cfg, key)
    step_fn, init_fn = pieces.step_fn, pieces.init_fn
    carry0 = jax.jit(init_fn)(target.init_positions(key, cfg.num_chain))
    keys = jax.random.split(key, n_iter)
    counts = jnp.arange(1, n_iter + 1)

    # --- the whole loop is one scanned on-device program
    @jax.jit
    def run_scan(carry, keys, counts):
        return jax.lax.scan(step_fn, carry, (keys, counts))

    t_scan, _ = _time_it(run_scan, carry0, keys, counts)

    # --- reference execution model: host loop, one step per dispatch, and a
    # device->host metric sync every iteration (wandb.log analogue)
    one_step = jax.jit(step_fn)
    carry, m = jax.block_until_ready(one_step(carry0, (keys[0], counts[0])))
    start = time.time()
    carry = carry0
    for i in range(n_iter):
        carry, metrics = one_step(carry, (keys[i], counts[i]))
        _ = {k: float(v) for k, v in metrics.items()}  # per-iter host sync
    jax.block_until_ready(carry)
    t_loop = time.time() - start

    return {
        "steps_per_sec_scan": n_iter / t_scan,
        "steps_per_sec_host_loop": n_iter / t_loop,
        "speedup": t_loop / t_scan,
    }


def bench_chain_scaling(n_steps=1000):
    """Chain-count scaling of ensemble MALA on one device (phi-four d=64):
    throughput should grow until the device saturates — the
    ensemble-batched design's headroom beyond the reference's 1024 chains.

    Reports MARGINAL throughput — steps/s from the wall-clock DIFFERENCE
    between a 4*n_steps and an n_steps scan — so the fixed per-dispatch
    cost, which small ensembles do not amortize, drops out."""
    from mfm_tpu.kernels import mala
    from mfm_tpu.targets import PhiFour

    target = PhiFour(64)
    vs = lambda x: target.value_and_score(x)
    kernel = mala.build_kernel(vs)
    key = jax.random.PRNGKey(0)
    out, out_overhead = {}, {}
    for n_chain in (1024, 4096, 16384, 65536):
        state = mala.init(target.init_positions(key, n_chain), vs)

        def make_run(steps):
            @jax.jit
            def run(state, key):
                def body(s, k):
                    s, _ = kernel(k, s, 1e-4)
                    return s, None

                return jax.lax.scan(
                    body, state, jax.random.split(key, steps)
                )[0]

            return run

        t1, _ = _time_it(make_run(n_steps), state, key, repeats=2)
        t4, _ = _time_it(make_run(4 * n_steps), state, key, repeats=2)
        marginal = 3 * n_steps * n_chain / max(t4 - t1, 1e-9)
        out[str(n_chain)] = round(marginal / 1e3, 1)  # K steps/s
        # per-call fixed cost implied by the two points (dispatch + launch)
        out_overhead[str(n_chain)] = round((t1 - (t4 - t1) / 3) * 1e3, 1)
    return {
        "chain_steps_kps_by_n_chain": out,
        "fixed_overhead_ms_by_n_chain": out_overhead,
    }


def bench_pines_flow_smc(n_train=3000, n_particles=512, n_steps=32):
    """Flow-annealed SMC detail row: train a short pines flow, anneal
    q0 -> pi, report the log-normalizer + anneal completion + device time
    (the round-3 weighted-sampler capability; full protocol in
    benchmarks/pines_flow_smc.py — at 10k training iters the normalizer
    is cross-validated at ~501.8 by plain SMC and Rademacher-probe
    flow-SMC, RESULTS.md "The pines log-normalizer resolved")."""
    from mfm_tpu.cli import make_target
    from mfm_tpu.config import preset
    from mfm_tpu.drivers.flow_smc import run_flow_smc
    from mfm_tpu.drivers.mfm import run_mfm

    cfg = preset("pines", learning_iter=n_train, mcmc_per_flow_steps=100.0,
                 adapt_step_size=True, alpha=0.8)
    target = make_target("pines")
    run = run_mfm(target, cfg)
    r = run_flow_smc(
        target, cfg, run.transport, run.train.params, run.ref_dist,
        key=jax.random.PRNGKey(7), n_particles=n_particles,
        n_steps=n_steps, num_mcmc_steps=4, steady_timing=True,
    )
    return {
        "train_time": round(run.train_time, 2),
        "smc_time": round(r.train_time, 2),
        "lmbda": float(r.lmbda),
        "log_z": round(float(r.log_z), 2),
        "ess_fraction": float(r.ess_fraction),
    }


def bench_pines_move_quality(n_train=4000, n_eval=512, n_moves=50):
    """Quality artifact: pines flow + IS + move correction KSD, so the
    per-round bench records quality alongside speed."""
    from mfm_tpu.cli import make_target
    from mfm_tpu.config import preset
    from mfm_tpu.diagnostics import stein_disc
    from mfm_tpu.drivers import run_mfm, sample_flow_move

    target = make_target("pines")
    cfg = preset("pines", learning_iter=n_train, chunk_size=1000)
    run = run_mfm(target, cfg)
    moved, is_resampled, _ = sample_flow_move(
        run, jax.random.PRNGKey(7), n_eval, target, n_moves=n_moves,
        init_step=cfg.step_size,
    )
    stein = jax.jit(lambda x: stein_disc(x, target.score, tile=256)[0])
    return {
        "train_time_s": round(run.train_time, 2),
        "ksd_u_is_resampled": float(stein(is_resampled)),
        "ksd_u_move_corrected": float(stein(moved)),
    }


def bench_new_examples(n_eval=4096, smc_particles=2048, smc_steps=32,
                       train_iter=None):
    """Beyond-reference examples end to end: funnel + many-well quality,
    and the many-well flow-SMC log-normalizer against quadrature truth
    (the d=32 many-well logZ is exactly computable: logZ = 16 * (log
    \\int exp(-x^4+6x^2+x/2) dx + 0.5 log 2pi))."""
    import numpy as np

    from mfm_tpu.cli import make_target
    from mfm_tpu.config import preset
    from mfm_tpu.drivers import evaluate_samples, run_mfm, sample_flow
    from mfm_tpu.drivers.flow_smc import run_flow_smc
    from mfm_tpu.drivers.mfm import mala_move_correct

    out = {}
    runs = {}
    for ex in ("funnel", "many-well"):
        cfg = preset(ex, seed=0)
        if train_iter is not None:  # tiny sizes for the contract test
            cfg.learning_iter = train_iter
            cfg.num_chain = 32
        target = make_target(ex)
        t0 = time.time()
        run = run_mfm(target, cfg)
        jax.block_until_ready(run.train.params)
        t_train = time.time() - t0
        fs, es, _ = sample_flow(run, jax.random.PRNGKey(1), n_eval, target)
        real = target.sample(jax.random.PRNGKey(2), (n_eval,))
        m = evaluate_samples(target, fs, es, real)
        out[ex] = {
            "train_time_s": t_train,
            "stein_u": float(m["stein_u"]),
            "stein_u_star": float(m["stein_u_star"]),
            "mmd": float(m["mmd"]),
        }
        runs[ex] = (run, cfg, target)

    # many-well: flow-SMC normalizer vs quadrature truth, then the move
    # correction on the resampled ensemble (mode weights are the hard part:
    # 2^16 modes whose relative mass the raw IS correction cannot fix)
    g = np.linspace(-4.0, 4.0, 400001)
    lp = -(g**4) + 6.0 * g**2 + 0.5 * g
    log_i = lp.max() + np.log(np.trapezoid(np.exp(lp - lp.max()), g))
    logz_true = 16.0 * (log_i + 0.5 * np.log(2.0 * np.pi))
    run, cfg, target = runs["many-well"]
    t0 = time.time()
    r = run_flow_smc(
        target, cfg, run.transport, run.train.params, run.ref_dist,
        key=jax.random.PRNGKey(100), n_particles=smc_particles,
        n_steps=smc_steps,
    )
    jax.block_until_ready(r.samples)
    t_smc = time.time() - t0
    key_pick = jax.random.PRNGKey(200)
    idx = jax.random.categorical(
        key_pick, jnp.log(r.weights), shape=(smc_particles,)
    )
    moved = mala_move_correct(
        r.samples[idx], target, jax.random.fold_in(key_pick, 1),
        n_moves=100, init_step=cfg.step_size,
    )
    real = target.sample(jax.random.PRNGKey(300), (smc_particles,))
    m = evaluate_samples(target, moved, moved, real)
    pairs = np.asarray(moved).reshape(-1, 16, 2)
    p_true = float(np.trapezoid(np.exp(lp - lp.max())[g > 0], g[g > 0])
                   / np.trapezoid(np.exp(lp - lp.max()), g))
    out["many_well_flow_smc"] = {
        "log_z": float(r.log_z),
        "log_z_true": float(logz_true),
        # quadrature E[log p] under the true posterior = 16*(E[w]-1/2):
        # 137.20 — the moved ensemble should match it
        "logpdf_moved": float(m["logpdf"]),
        "lmbda": float(r.lmbda),
        "smc_time_s": t_smc,
        "stein_u_moved": float(m["stein_u"]),
        "mmd_moved": float(m["mmd"]),
        "p_x1_pos_moved": float((pairs[..., 0] > 0).mean()),
        "p_x1_pos_true": p_true,
    }
    return out


def bench_phi_four_mala(n_chain=1024, n_steps=2000):
    from mfm_tpu.kernels import mala
    from mfm_tpu.targets import PhiFour

    target = PhiFour(64)
    vs = lambda x: target.value_and_score(x)
    kernel = mala.build_kernel(vs)
    key = jax.random.PRNGKey(0)
    state = mala.init(target.init_positions(key, n_chain), vs)

    @jax.jit
    def run(state, key):
        def body(s, k):
            s, info = kernel(k, s, 1e-4)
            return s, info.acceptance_rate.mean()

        return jax.lax.scan(body, state, jax.random.split(key, n_steps))

    t, _ = _time_it(run, state, key)
    return {"chain_steps_per_sec": n_chain * n_steps / t}


def bench_pines_step(n_chain=128, n_steps=400):
    """Steady-state ensemble MALA on the LGCP target; n_steps amortizes
    the per-dispatch overhead."""
    from mfm_tpu.kernels import mala
    from mfm_tpu.targets import LogGaussianCoxPines

    target = LogGaussianCoxPines(1600)
    vs = lambda x: target.value_and_score(x)
    kernel = mala.build_kernel(vs)
    key = jax.random.PRNGKey(0)
    state = mala.init(target.init_positions(key, n_chain), vs)

    @jax.jit
    def run(state, key):
        def body(s, k):
            s, _ = kernel(k, s, 0.01)
            return s, None

        return jax.lax.scan(body, state, jax.random.split(key, n_steps))[0]

    t, _ = _time_it(run, state, key)
    return {"chain_steps_per_sec": n_chain * n_steps / t}


def bench_roofline():
    """Absolute hardware-utilization accounting for the three hot loops:
    FLOPs/bytes from XLA's cost model of the compiled executable,
    wall-clock from the same executable, %-of-peak against the device's
    data-sheet ceilings (diagnostics/roofline.py). All three run their
    products at Precision.HIGHEST, so they are held to the f32 peak."""
    from mfm_tpu.diagnostics.metrics import stein_disc
    from mfm_tpu.diagnostics.roofline import device_peaks, roofline
    from mfm_tpu.kernels import mala
    from mfm_tpu.targets import LogGaussianCoxPines, four_mode_mixture

    reports = {}
    key = jax.random.PRNGKey(0)

    # 1. ensemble MALA on the LGCP target (the headline's 99% phase):
    # per-step cost is one fused precision-GEMM value_and_score
    target = LogGaussianCoxPines(1600)
    vs = lambda x: target.value_and_score(x)
    kernel = mala.build_kernel(vs)
    state = mala.init(target.init_positions(key, 128), vs)
    n_steps = 400

    def run_mala(state, key):
        def body(s, k):
            s, _ = kernel(k, s, 0.01)
            return s, None
        return jax.lax.scan(body, state, jax.random.split(key, n_steps))[0]

    r = roofline("mala_lgcp_128x400", run_mala, state, key,
                 loop_reps=n_steps)
    reports["mala_lgcp"] = dict(
        r.as_dict(), chain_steps_per_sec=128 * n_steps / r.seconds)

    # 2. one full CNF transport push (24-step RK4, Hutchinson divergence)
    # at the pines field size — the flow-step / final-sampling hot path
    from mfm_tpu.flows.cnf import make_transport
    from mfm_tpu.flows.vector_field import make_vector_field

    apply_fn, params = make_vector_field(
        key, 1600, hidden_x=(), hidden_t=(), hidden_xt=(1024, 1024),
        score_fn=target.score, score_clip=10.0)
    transport = make_transport(apply_fn, "hutchinson", n_steps=24)
    u = jax.random.normal(key, (128, 1600))

    def run_transport(params, u, key):
        return transport.forward(params, u, key)

    r = roofline("rk4_transport_pines_128", run_transport, params, u, key,
                 loop_reps=24)
    reports["rk4_transport"] = dict(
        r.as_dict(), samples_per_sec=128 / r.seconds)

    # 3. tiled O(T^2) Stein discrepancy at the eval size (12.8k samples)
    t4 = four_mode_mixture()
    X = t4.sample(key, (12800,))

    def run_stein(X):
        return stein_disc(X, t4.score)

    # metrics row-tiling: lax.map over T/tile row chunks (tile=128)
    r = roofline("stein_tiled_12800", run_stein, X, loop_reps=12800 // 128)
    reports["stein_tiled"] = dict(
        r.as_dict(), pairs_per_sec=12800.0 * 12800.0 / r.seconds)

    peak_f, peak_b = device_peaks()
    reports["peaks"] = {
        "device_kind": getattr(jax.devices()[0], "device_kind", "?"),
        "peak_flops_per_sec": peak_f,
        "peak_bytes_per_sec": peak_b,
        "caveats": "bytes = XLA logical operand traffic (upper bound on "
                   "device-memory traffic); peaks are the full-f32 rates",
    }
    return reports


def bench_mfm_steady(example: str, n_iter: int, repeats: int = 3, **overrides):
    """Median steady-state MFM training rate over `repeats` runs of the same
    compiled scan program (compile excluded; medians damp run-to-run noise,
    the round-1 weakness on the latency-bound 4-mode headline)."""
    from mfm_tpu.cli import make_target
    from mfm_tpu.config import preset
    from mfm_tpu.drivers.mfm import build_mfm

    cfg = preset(example, learning_iter=n_iter, **overrides)
    target = make_target(example)
    key = jax.random.PRNGKey(0)
    pieces = build_mfm(target, cfg, key)
    step_fn, init_fn = pieces.step_fn, pieces.init_fn
    carry0 = jax.jit(init_fn)(target.init_positions(key, cfg.num_chain))
    keys = jax.random.split(key, n_iter)
    counts = jnp.arange(1, n_iter + 1)

    @jax.jit
    def run_scan(carry, keys, counts):
        return jax.lax.scan(step_fn, carry, (keys, counts))

    jax.block_until_ready(run_scan(carry0, keys, counts))  # compile + warm
    rates = []
    for _ in range(repeats):
        start = time.time()
        jax.block_until_ready(run_scan(carry0, keys, counts))
        rates.append(n_iter / (time.time() - start))
    return {
        "iters_per_sec_median": statistics.median(rates),
        "iters_per_sec_runs": rates,
    }


def bench_pines_north_star(n_chain=4096, n_iter=400):
    """The 4096-chain operating point: pines (d=1600) with its preset
    field precision at 4096 parallel chains on ONE device. The n_chain=128
    headline row measures reference parity; this row measures the
    throughput the ensemble-batched design unlocks, with the hot loop's
    roofline utilization recorded next to it."""
    from mfm_tpu.diagnostics.roofline import roofline
    from mfm_tpu.kernels import mala
    from mfm_tpu.targets import LogGaussianCoxPines

    steady = bench_mfm_steady(
        "pines", n_iter=n_iter, num_chain=n_chain,
        mcmc_per_flow_steps=100.0,
    )
    # roofline of the 99% phase (ensemble MALA) at the same ensemble size
    target = LogGaussianCoxPines(1600)
    vs = lambda x: target.value_and_score(x)
    kernel = mala.build_kernel(vs)
    key = jax.random.PRNGKey(0)
    state = mala.init(target.init_positions(key, n_chain), vs)
    n_steps = 100

    def run_mala(state, key):
        def body(s, k):
            s, _ = kernel(k, s, 0.01)
            return s, None

        return jax.lax.scan(body, state, jax.random.split(key, n_steps))[0]

    r = roofline(f"mala_lgcp_{n_chain}x{n_steps}", run_mala, state, key,
                 loop_reps=n_steps)
    return {
        "n_chain": n_chain,
        "iters_per_sec_median": steady["iters_per_sec_median"],
        "chain_steps_per_sec": steady["iters_per_sec_median"] * n_chain,
        "mala_roofline": r.as_dict(),
    }


def bench_baselines(example="4-mode", seeds=(0,), iters_scale=1.0):
    """Measured MFM-vs-baseline rows: MFM, adaptive tempered SMC, and the
    in-repo FAB / flowMC / DDS at the reference 4-mode benchmark config,
    shared metric schema (exe_others.py:42-299 +
    exe_flow_matching.py:462-490). One seed here keeps the bench inside its
    subprocess budget; the full 3-seed protocol over 4-mode / many-well /
    16-mode is benchmarks/baseline_showdown.py."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks", "baseline_showdown.py")
    spec = importlib.util.spec_from_file_location("baseline_showdown", path)
    sd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sd)
    out = sd.run_showdown(
        targets=(example,), methods=("mfm", "smc", "fab", "flowmc", "dds"),
        seeds=tuple(seeds), iters_scale=iters_scale,
    )
    return out["tables"].get(example, {"error": "no table produced",
                                       "cells": out["cells"]})


# --- bench registry: name -> (module attr, args, kwargs), resolved lazily
# through globals() at call time so tests can monkeypatch the functions.
_CHILD_TAG = "BENCHCHILD:"
_BENCHES = {
    # headline: pines MFM steady training rate, median of 3 repeats. 2000
    # iters amortize the launch/stacking overhead of one scan and carry the
    # steady 1-in-101 flow-step fraction
    "headline": ("bench_mfm_steady", ("pines",),
                 {"n_iter": 2000, "mcmc_per_flow_steps": 100.0}),
    "mfm_4mode": ("bench_mfm_4mode", (), {}),
    "phi_four_mala": ("bench_phi_four_mala", (), {}),
    "pines_mala": ("bench_pines_step", (), {}),
    "mfm_phi_four_steady": ("bench_mfm_steady", ("phi-four", 300),
                            {"mcmc_per_flow_steps": 100.0}),
    "chain_scaling": ("bench_chain_scaling", (), {}),
    "pines_flow_smc": ("bench_pines_flow_smc", (), {}),
    "new_examples": ("bench_new_examples", (), {}),
    "roofline": ("bench_roofline", (), {}),
    "pines_north_star": ("bench_pines_north_star", (), {}),
    "baselines": ("bench_baselines", (), {}),
    # a 4000-iteration pines training run: hours on the 1-core CPU host,
    # so opt-in only (BENCH_QUALITY=1 python bench.py)
    "pines_move_quality": ("bench_pines_move_quality", (), {}),
}


def _call_bench(name):
    from mfm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    attr, args, kwargs = _BENCHES[name]
    out = globals()[attr](*args, **kwargs)
    dev = jax.devices()[0]
    return {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "result": out,
    }


def run_bench_isolated(name, timeout=3000):
    """Run one bench in a SUBPROCESS; return (payload | None, error | None).

    A crashed child is recorded instead of escaping main(), and the parent —
    which never initializes the JAX backend — still emits the
    machine-readable result. Children run one at a time, so one process
    holds the accelerator. MFM_BENCH_INPROCESS=1 short-circuits to a direct
    call (test hook; also lets monkeypatched bench functions take effect).
    """
    import subprocess
    import sys

    if os.environ.get("MFM_BENCH_INPROCESS"):
        try:
            return _call_bench(name), None
        except Exception as e:
            return None, repr(e)
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", name],
            capture_output=True, text=True, timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return None, f"bench child {name!r} timed out after {timeout}s"
    for line in reversed(r.stdout.splitlines()):
        if line.startswith(_CHILD_TAG):
            try:
                return json.loads(line[len(_CHILD_TAG):]), None
            except ValueError:
                break
    tail = (r.stderr or r.stdout or "")[-500:]
    return None, f"bench child {name!r} rc={r.returncode}: {tail}"


def _child_main(name):
    import sys

    payload = _call_bench(name)
    print(_CHILD_TAG + json.dumps(payload))
    sys.stdout.flush()


def _emit_headline_failure(error):
    import sys

    print(
        json.dumps(
            {
                "metric": "mfm_pines_train_iters_per_sec",
                "value": None,
                "unit": "iters/sec",
                "vs_baseline": None,
                "error": error,
            }
        )
    )
    sys.exit(2)


def main():
    import sys

    t_start = time.time()
    # self-enforced global deadline: every child timeout is sized to the
    # remaining budget; when it runs out, remaining benches are skipped
    # WITH a recorded reason instead of dying silently.
    budget = float(os.environ.get("MFM_BENCH_BUDGET_S", 5400))

    def remaining():
        return budget - (time.time() - t_start)

    details = {}

    def dump():
        with open("BENCH_DETAILS.json", "w") as fh:
            json.dump(details, fh, indent=2)

    if remaining() < 180:
        _emit_headline_failure(
            f"bench budget ({budget:.0f}s) exhausted before headline")
    payload, err = run_bench_isolated(
        "headline", timeout=min(3000, max(remaining() - 60, 120)))
    if payload is None:
        _emit_headline_failure(err)
    headline = payload["result"]
    details["device"] = payload.get("device")
    details["mfm_pines_steady"] = headline

    # vs_baseline: measured rate of the UNMODIFIED reference on a CPU host,
    # x64 (benchmarks/run_reference.py artifact)
    ref_rate = 20.2
    try:
        with open("benchmarks/reference_pines_cpu.json") as fh:
            ref = json.load(fh)
        rate = ref.get("steady_iters_per_sec_estimate")
        if isinstance(rate, (int, float)) and rate > 0:  # guard null/0
            ref_rate = rate
        details["reference_baseline"] = {
            "steady_iters_per_sec": ref_rate,
            "wall_total": ref.get("wall_total"),
            "learning_iter": ref.get("learning_iter"),
        }
    except (OSError, ValueError):
        pass

    # the headline line goes out immediately; detail benches follow and may
    # be cut off by an external timeout without losing the result
    print(
        json.dumps(
            {
                "metric": "mfm_pines_train_iters_per_sec",
                "value": round(headline["iters_per_sec_median"], 2),
                "unit": "iters/sec",
                "vs_baseline": round(headline["iters_per_sec_median"] / ref_rate, 3),
            }
        )
    )
    sys.stdout.flush()

    names = [
        "mfm_4mode", "phi_four_mala", "pines_mala", "mfm_phi_four_steady",
        "chain_scaling", "pines_flow_smc", "new_examples", "roofline",
        "pines_north_star", "baselines",
    ] + (["pines_move_quality"] if os.environ.get("BENCH_QUALITY") else [])
    for name in names:
        if remaining() < 90:
            details[name] = {
                "error": f"skipped: bench budget ({budget:.0f}s) exhausted "
                         f"after {time.time() - t_start:.0f}s"}
            dump()
            continue
        # pre-write the entry BEFORE launching the child so even a
        # SIGKILL'd parent leaves a record of what was in flight
        details[name] = {
            "error": f"bench {name!r} launched but never returned "
                     "(parent killed mid-bench?)"}
        dump()
        payload, err = run_bench_isolated(
            name, timeout=min(2400, max(remaining() - 30, 60)))
        # secondary benches must not kill the headline
        details[name] = payload["result"] if payload is not None else {"error": err}
        dump()


if __name__ == "__main__":
    import sys

    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        _child_main(sys.argv[2])
    else:
        main()
