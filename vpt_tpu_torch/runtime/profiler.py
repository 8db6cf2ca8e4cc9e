"""Render-loop instrumentation: rays/s counters and stage timings.

Mirrors ``vpt_tpu/runtime/profiler.py``: per-stage wall times,
progressive frame counts and derived events/s.  A stage times the host
call; on the card the work it launches may still be running when the stage
ends, as under JAX's async dispatch, so a caller that wants the card's time
synchronizes first (``cli render`` ends its total in
``torch.cuda.synchronize()``).  For deep traces use ``torch.profiler``
around a render loop (``cli render --trace DIR``); this module only
provides the cheap always-on counters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.seconds / max(self.calls, 1)


class RenderProfiler:
    """Accumulates per-stage timings and pixel-event counts."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = defaultdict(StageStats)
        self.events = 0

    @contextlib.contextmanager
    def stage(self, name: str, events: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            st = self.stages[name]
            st.calls += 1
            st.seconds += dt
            self.events += events

    def events_per_second(self, stage: str = "render_frame") -> float:
        st = self.stages.get(stage)
        if not st or st.seconds == 0:
            return 0.0
        return self.events / st.seconds

    def summary(self) -> str:
        lines = []
        for name, st in sorted(self.stages.items()):
            lines.append(
                f"{name}: {st.calls} calls, {st.mean_ms:.2f} ms/call")
        if self.events:
            lines.append(
                f"throughput: {self.events_per_second():.3e} events/s")
        return "\n".join(lines)


def photon_stats(state, max_bounces: int = 16) -> dict:
    """MCM photon-state telemetry: in-flight bounce-depth histogram,
    samples-per-pixel statistics, and transmittance/radiance means (float32
    means, as ``vpt_tpu`` takes them).

    One device→host sync per value — intended for periodic logging, not the
    hot loop.  ``state`` is an MCM state (renderers/mcm.py)."""
    import torch

    bounces = torch.clamp(state["bounces"].to(torch.int32), 0, max_bounces)
    hist = torch.bincount(bounces.flatten().to(torch.int64),
                          minlength=max_bounces + 1)
    samples = state["samples"]
    return {
        "bounce_histogram": hist.cpu().tolist(),
        "mean_bounces": float(state["bounces"].mean()),
        "samples_per_pixel": {
            "mean": float(samples.mean()),
            "min": float(samples.min()),
            "max": float(samples.max()),
        },
        "mean_transmittance": float(state["transmittance"].mean()),
        "mean_radiance": float(state["radiance"].mean()),
    }
