"""Step timing and profiler integration.

The reference's tracing is hand-rolled `cudaEvent_t` wall-time prints per
solver step and host `chrono` timers for collision sub-phases
(`SyncedNewton.cu:946-948,1384-1390`;
`test_sphere_drop_collision.cc:270-278,448-473`). Here:

- `StepTimer` — named-phase accumulator with the same per-phase ms/step
  averages, plus percentiles;
- `trace` — context manager around `jax.profiler` for device traces
  (TensorBoard-compatible), which the reference has no equivalent of.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

__all__ = ["StepTimer", "trace"]


class StepTimer:
    """Accumulates wall-time per named phase; blocks on device results so
    timings are real (pass the phase's output to `stop`)."""

    def __init__(self):
        self._samples: dict[str, list[float]] = defaultdict(list)
        self._open: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                import jax

                jax.block_until_ready(block_on)
            self._samples[name].append(time.perf_counter() - t0)

    def start(self, name: str):
        self._open[name] = time.perf_counter()

    def stop(self, name: str, block_on=None):
        if block_on is not None:
            import jax

            jax.block_until_ready(block_on)
        self._samples[name].append(time.perf_counter() - self._open.pop(name))

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            a = np.asarray(xs) * 1e3
            out[name] = {
                "count": len(xs),
                "mean_ms": float(a.mean()),
                "p50_ms": float(np.median(a)),
                "p95_ms": float(np.percentile(a, 95)),
                "total_s": float(a.sum() / 1e3),
            }
        return out

    def report(self) -> str:
        lines = [f"{'phase':<24}{'count':>7}{'mean ms':>10}{'p50 ms':>10}{'p95 ms':>10}"]
        for name, s in self.summary().items():
            lines.append(
                f"{name:<24}{s['count']:>7}{s['mean_ms']:>10.3f}"
                f"{s['p50_ms']:>10.3f}{s['p95_ms']:>10.3f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
