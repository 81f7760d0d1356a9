"""Shared end-of-run evaluation: log-density, Stein discrepancies, MMD.

Parity with the reference's final metric block
(/root/reference/exe_flow_matching.py:462-490 and exe_others.py:301-340):
``logpdf`` / ``logpdf*`` (flow vs IS-corrected samples), KSD U/V statistics,
MMD vs ground-truth samples when the target has an exact sampler, and the
``check`` floor computed from real samples against themselves.
"""

from typing import Optional

import jax
import jax.numpy as jnp

from mfm_tpu.diagnostics import max_mean_disc, stein_disc
from mfm_tpu.targets.base import Target


def evaluate_samples(
    target: Target,
    flow_samples: jax.Array,
    exact_samples: jax.Array,
    real_samples: Optional[jax.Array] = None,
    log_weights: Optional[jax.Array] = None,
) -> dict:
    """Compute the reference metric row for one run.

    ``log_weights`` (optional, per flow sample): adds importance-WEIGHTED
    Stein statistics of the flow samples — the duplication-free view of the
    IS-corrected distribution (new capability; see diagnostics.stein_disc).
    """
    out = {}
    out["logpdf"] = float(jnp.mean(target.log_prob(flow_samples)))
    u, v = stein_disc(flow_samples, target.score)
    out["stein_u"], out["stein_v"] = float(u), float(v)

    out["logpdf_star"] = float(jnp.mean(target.log_prob(exact_samples)))
    u_, v_ = stein_disc(exact_samples, target.score)
    out["stein_u_star"], out["stein_v_star"] = float(u_), float(v_)

    if log_weights is not None:
        w = jnp.exp(log_weights - jnp.max(log_weights))
        uw, vw = stein_disc(flow_samples, target.score, weights=w)
        out["stein_u_weighted"], out["stein_v_weighted"] = float(uw), float(vw)

    if real_samples is not None:
        out["mmd"] = float(max_mean_disc(real_samples, flow_samples))
        out["mmd_star"] = float(max_mean_disc(real_samples, exact_samples))
    else:
        out["mmd"] = out["mmd_star"] = 0.0
    return out


def check_floor(target: Target, real_samples: jax.Array) -> dict:
    """Sanity floor: metrics of exact samples against themselves
    (reference --check mode, exe_flow_matching.py:462-467)."""
    u, v = stein_disc(real_samples, target.score)
    return {
        "logpdf_real": float(jnp.mean(target.log_prob(real_samples))),
        "stein_u_real": float(u),
        "stein_v_real": float(v),
        "mmd_real": float(max_mean_disc(real_samples, real_samples)),
    }


def report_row(cfg, metrics: dict, train_time: float) -> list:
    """The reference's summary-table row layout
    (exe_flow_matching.py:477-488)."""
    row = [
        cfg.mcmc_per_flow_steps,
        cfg.learning_iter,
        train_time,
        metrics["logpdf"],
        metrics["logpdf_star"],
        metrics["stein_u"],
        metrics["stein_u_star"],
        metrics["stein_v"],
        metrics["stein_v_star"],
    ]
    if metrics.get("mmd") is not None:
        row += [metrics["mmd"], metrics["mmd_star"]]
    return row


def aggregate_seeds(rows: list) -> dict:
    """mean +/- 1.96 sigma over seeds (reference multi_modal.py:133-143)."""
    import numpy as np

    arr = np.asarray(rows, dtype=np.float64)
    return {
        "mean": arr.mean(axis=0),
        "ci95": 1.96 * arr.std(axis=0),
    }
