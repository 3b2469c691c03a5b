"""Cross-cutting utilities: profiling and tracing."""

from .profiling import phase_report, phase_timer, trace

__all__ = ["phase_timer", "phase_report", "trace"]
