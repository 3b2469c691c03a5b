"""Cross-cutting utilities: profiling, tracing and the completion
barrier ``sync``. The JAX package's ``force_platform`` has no
counterpart: the device is chosen by ``core/device.py::resolve``."""

from .profiling import phase_report, phase_timer, sync, trace

__all__ = ["phase_timer", "phase_report", "trace", "sync"]
