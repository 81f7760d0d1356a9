"""Roofline accounting: tie measured wall-clock to hardware ceilings.

The reference publishes no utilization numbers at all (SURVEY.md section 6);
perf claims are anchored to the device's roofline rather than to a
same-host CPU ratio. This module does that reproducibly:

- FLOP and byte counts come from XLA's own cost model of the COMPILED
  executable (``compiled.cost_analysis()``), not from hand-derived formulas
  that drift when the kernel changes;
- wall-clock comes from executing the same compiled object;
- ceilings are the device's data-sheet numbers (table below), selected by
  the device kind at runtime.

The % figures are honest bounds, with three caveats stated here once:
XLA's "bytes accessed" counts logical operand/result traffic, which
over-counts fused intermediates that never touch device memory (so %HBM is
an upper bound on achieved bandwidth); an f32 matmul runs either in full
f32 on the CUDA cores (``Precision.HIGHEST``, 67 TFLOP/s peak on an H100)
or in TF32 on the tensor cores (the default precision, 495 TFLOP/s), so a
share is only meaningful against the peak of the precision that ran; and
XLA's cost model counts a ``while``/``scan`` BODY exactly once regardless
of trip count, so callers must pass the loop trip count as ``loop_reps``
when the measured fn is scan-dominated.
"""

import time
from typing import Callable, NamedTuple, Optional

import jax

# device_kind -> (dense full-f32 peak FLOP/s, device-memory bytes/s). NVIDIA
# H100 SXM data sheet (dense, no sparsity, at the 700 W power limit): 67
# TFLOP/s f32, 3.35 TB/s HBM3. Its tensor-core peaks, 495 TFLOP/s TF32 and
# 989 bf16, are not tabled: every loop measured here pins HIGHEST.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (67.0e12, 3.35e12),
}


class RooflineReport(NamedTuple):
    name: str
    flops: float  # XLA cost model, per execution
    bytes_accessed: float  # XLA cost model, per execution (upper bound)
    seconds: float  # measured median wall-clock per execution
    achieved_flops_per_sec: float
    achieved_bytes_per_sec: float
    pct_peak_flops: Optional[float]  # None on the CPU (no ceiling to cite)
    pct_peak_bandwidth: Optional[float]
    bound: str  # 'compute' | 'memory' per the cost model's intensity

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._fields}


def device_peaks(device=None):
    """(full-f32 peak_flops, peak_bytes_per_sec) of ``device``; (None, None)
    on the CPU, which has no ceiling to cite. Any other device kind missing
    from the table is an error, not a default."""
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return None, None
    kind = getattr(device, "device_kind", "")
    if kind not in _PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add its data-sheet "
            "numbers to mfm_tpu.diagnostics.roofline._PEAKS"
        )
    return _PEAKS[kind]


def roofline(name: str, fn: Callable, *args, repeats: int = 3,
             loop_reps: int = 1,
             lower_kwargs: Optional[dict] = None) -> RooflineReport:
    """Compile ``fn(*args)``, pull FLOPs/bytes from XLA's cost analysis,
    measure median execution time, and situate it against the chip peaks.

    ``loop_reps``: trip count of the dominant ``lax.scan``/``while`` inside
    ``fn``. XLA's cost model counts a loop body once (module docstring), so
    the reported FLOPs/bytes are multiplied by this. Slightly over-counts
    the outside-the-loop part (counted once by XLA, scaled here anyway),
    which is negligible exactly when the loop dominates — the only regime
    where a roofline number is meaningful. The FLOP/s ceiling is the
    full-f32 one: the hot loops measured here pin ``Precision.HIGHEST``."""
    compiled = (
        jax.jit(fn, **(lower_kwargs or {})).lower(*args).compile()
    )
    cost = compiled.cost_analysis()
    if isinstance(cost, list):  # older jax returns one dict per computation
        cost = cost[0]
    flops = float(cost.get("flops", 0.0)) * loop_reps
    bytes_accessed = float(cost.get("bytes accessed", 0.0)) * loop_reps

    jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    seconds = sorted(times)[len(times) // 2]

    peak_f, peak_b = device_peaks()
    ach_f = flops / seconds
    ach_b = bytes_accessed / seconds
    # which wall is closer, by the cost model's arithmetic intensity
    if peak_f and peak_b:
        bound = "compute" if (flops / max(bytes_accessed, 1.0)) > (
            peak_f / peak_b) else "memory"
    else:
        bound = "memory" if bytes_accessed > flops else "compute"
    return RooflineReport(
        name=name,
        flops=flops,
        bytes_accessed=bytes_accessed,
        seconds=seconds,
        achieved_flops_per_sec=ach_f,
        achieved_bytes_per_sec=ach_b,
        pct_peak_flops=(100.0 * ach_f / peak_f) if peak_f else None,
        pct_peak_bandwidth=(100.0 * ach_b / peak_b) if peak_b else None,
        bound=bound,
    )
