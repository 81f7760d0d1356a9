"""mfm_tpu: a Markovian Flow Matching framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``albcab/mfm`` repository (MFM: Accelerating MCMC with Continuous Normalizing
Flows). Everything is built batch-first for an accelerator, runs training loops
on-device with ``lax.scan``, and scales chain ensembles over a
``jax.sharding.Mesh``.

Layout
------
- ``targets``      unnormalized target densities (the "models")
- ``kernels``      batched MCMC transition kernels (MALA, TESS, CIS, ...)
- ``flows``        CNF vector field, flow-matching losses, ODE transport,
                   flow-proposal MH kernels
- ``smc``          sequential Monte Carlo (tempered / adaptive, resampling)
- ``adaptation``   cross-chain / ensemble-chain adaptation loops (ATESS, MSC)
- ``vi``           SVGD + coin-SVGD, COCOB optimizer
- ``sbi``          simulation-based inference scaffolding (SNPE-A)
- ``diagnostics``  Stein discrepancy, MMD, autocorrelation, ESS
- ``parallel``     mesh / sharding utilities
- ``drivers``      end-to-end orchestrators (MFM training, SMC runs, eval)
"""

__version__ = "0.1.0"
