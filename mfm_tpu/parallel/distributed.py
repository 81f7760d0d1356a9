"""Multi-process seed replication.

SURVEY.md section 2.8 (last row): the reference's 10-seed replication loop
(/root/reference/multi_modal.py:118-131) is embarrassingly parallel across
hosts — each process runs its own seeds and only the final 5-metric rows
cross processes. This module is that story made concrete:

- ``initialize_distributed`` brings up ``jax.distributed`` (for tests and
  demos on multi-process CPU via the gloo collectives backend + a forced
  per-process device count).
- ``local_seeds`` deals each process its strided share of the seed list.
- ``allgather_rows`` moves every process's metric rows to every process
  (one tiny all-gather), so each one can print the identical
  mean ± 1.96σ aggregation row.

Demo/runbook: ``python benchmarks/run_distributed_seeds.py`` (spawns two
local CPU processes); the subprocess test in
``tests/test_distributed_seeds.py`` runs the same path. On a GPU host one
process drives every card; these multi-process paths stay CPU demos.
"""

from typing import Optional, Sequence

import numpy as np


def force_cpu_devices(n_devices: int, collectives: Optional[str] = None):
    """Force a virtual n-device CPU platform. Must run before any JAX
    backend exists (this module is import-pure for exactly that reason).

    The environment may preset an accelerator platform, and once JAX has
    been imported the env var alone no longer decides — the jax.config
    update is required too.
    One shared implementation for __graft_entry__.dryrun_multichip and the
    multi-process CPU demos (tests/conftest.py keeps its own copy so the
    test bootstrap never depends on the package under test).
    """
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    for name, value in (
        ("jax_platforms", "cpu"),
        ("jax_num_cpu_devices", n_devices),
    ):
        try:
            jax.config.update(name, value)
        except Exception:  # older jax / backend already up — best effort
            pass
    if collectives is not None:
        jax.config.update("jax_cpu_collectives_implementation", collectives)
    return jax


def initialize_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    cpu_devices_per_process: Optional[int] = None,
):
    """Bring up the multi-process JAX runtime.

    The three arguments must be given explicitly where nothing tells JAX
    of a cluster (``localhost:<port>`` for local processes). For CPU demos,
    ``cpu_devices_per_process`` forces a virtual device count per process
    and selects the gloo cross-process collectives backend. Must run before
    any JAX backend is initialized.
    """
    if cpu_devices_per_process is not None:
        jax = force_cpu_devices(cpu_devices_per_process, collectives="gloo")
    else:
        import jax
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax


def local_seeds(seeds: Sequence[int], process_id: int, num_processes: int):
    """This process's strided share. Requires an even split so the final
    row all-gather has equal shapes on every process."""
    if len(seeds) % num_processes:
        raise ValueError(
            f"{len(seeds)} seeds do not split evenly over "
            f"{num_processes} processes; pad the seed list"
        )
    return list(seeds)[process_id::num_processes]


def allgather_rows(rows_local) -> np.ndarray:
    """All-gather per-process metric rows; returns (total_rows, k) stacked
    in process order, identical on every process."""
    from jax.experimental import multihost_utils

    rows_local = np.atleast_2d(np.asarray(rows_local, np.float64))
    gathered = multihost_utils.process_allgather(rows_local)  # (P, n, k)
    return np.asarray(gathered).reshape(-1, rows_local.shape[-1])


def aggregate_row(rows: np.ndarray):
    """mean ± 1.96σ over seeds (reference multi_modal.py:133-143)."""
    rows = np.asarray(rows, np.float64)
    return rows.mean(axis=0), 1.96 * rows.std(axis=0)
