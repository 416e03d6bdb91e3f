"""Observability of the port: only ``EventLog`` so far (the metrics
registry, spans and device monitors are ROADMAP queue 1, item 15)."""
from repro_torch.obs.logs import EventLog  # noqa: F401
