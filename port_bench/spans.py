"""The program's spans (``mpgan_torch.tracing``), as the per-layer readers
of ``metrics/`` take them: from the store of the run's process, after the
traced window, in which the profiler turned tracing on. A program without
spans gives None, as does a window in which none of a metric's spans was
recorded; the metric is then left out."""

from __future__ import annotations


def load() -> list[dict] | None:
    """Every span the program stored, or None where it has no store."""
    try:
        from mpgan_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def named(spans: list[dict] | None, *names: str) -> list[dict]:
    return [s for s in spans or () if s["name"] in names]


def host_ms(s: dict) -> float:
    return (s["host_end_ns"] - s["host_start_ns"]) * 1e-6


def device_ms(s: dict) -> float:
    return s["device_end_ms"] - s["device_start_ms"]
