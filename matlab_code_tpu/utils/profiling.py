"""Profiling / observability utilities.

Far beyond the reference's tic/toc + inner-iteration counters
(cmtf_fun_AOADMM.m:41,455; SURVEY.md §5): per-phase wall timers, analytic
FLOP/byte counts for the sweep's hot kernels, a roofline summary, and a hook
into the JAX profiler for full XLA traces.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np

from matlab_code_tpu.problem import ProblemSpec, CP, PAR2


@dataclass
class Timer:
    """Nested wall-clock phase timer."""
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(f"{k:30s} {v:10.4f} s  x{self.counts[k]}"
                         for k, v in rows)


def sweep_flops(spec: ProblemSpec, dtype_bytes: int = 4) -> dict:
    """Analytic FLOPs and HBM bytes of ONE outer AO sweep's MTTKRP-class
    kernels (the dominant cost; cmtf_fun_AOADMM.m:97 etc.)."""
    flops = 0
    bytes_ = 0
    for p, ds in enumerate(spec.datasets):
        R = ds.rank
        if ds.model == CP:
            sizes = [spec.mode_sizes[m] for m in ds.modes]
            nnz = int(np.prod(sizes))
            flops += 2 * nnz * R * len(sizes)      # one MTTKRP per mode
            bytes_ += nnz * dtype_bytes * len(sizes)
        else:
            K = spec.par2_K(p)
            I = spec.mode_sizes[ds.modes[0]]
            Jmax = spec.par2_Jmax(p)
            nnz = K * I * Jmax
            flops += 3 * 2 * nnz * R               # A/Bk/C sweeps
            bytes_ += 3 * nnz * dtype_bytes
    return {"flops_per_sweep": flops, "hbm_bytes_per_sweep": bytes_}


# Published peak rates, keyed by jax's `device_kind`.  NVIDIA H100 SXM data
# sheet: dense rates without sparsity, at the card's full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
    },
}


def device_peaks(device_kind: str | None = None) -> dict:
    """Peak rates of `device_kind` (default: the first JAX device's).  A
    device missing from PEAKS is an error, never a default."""
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    if device_kind not in PEAKS:
        raise ValueError(f"no peak rates for device kind {device_kind!r}; "
                         f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind]


def roofline_report(spec: ProblemSpec, seconds_per_iter: float,
                    device_kind: str | None = None,
                    flops_key: str = "tf32_flops",
                    dtype_bytes: int = 4) -> str:
    """Roofline position of the measured outer iteration against the peaks
    of `device_kind` (device_peaks).  flops_key names the matmul peak that
    matches the run's precision: 'tf32_flops' for float32 at 'default' on
    a GPU, 'fp32_flops' at 'highest', 'bf16_flops' for bfloat16."""
    peaks = device_peaks(device_kind)
    peak_flops, peak_bw = peaks[flops_key], peaks["hbm_bytes_per_s"]
    s = sweep_flops(spec, dtype_bytes)
    achieved_f = s["flops_per_sweep"] / seconds_per_iter
    achieved_b = s["hbm_bytes_per_sweep"] / seconds_per_iter
    return (f"sweep: {s['flops_per_sweep']/1e9:.2f} GFLOP, "
            f"{s['hbm_bytes_per_sweep']/1e6:.1f} MB\n"
            f"achieved: {achieved_f/1e9:.1f} GFLOP/s "
            f"({100*achieved_f/peak_flops:.1f}% of {flops_key} peak), "
            f"{achieved_b/1e9:.1f} GB/s "
            f"({100*achieved_b/peak_bw:.1f}% of HBM peak)")


@contextlib.contextmanager
def xla_trace(logdir: str):
    """Capture a full XLA profile viewable in TensorBoard/XProf."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
