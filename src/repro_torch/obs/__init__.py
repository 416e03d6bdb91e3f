"""Observability of the port: driver logging (``setup_logging``,
``JsonFormatter``) and ``EventLog`` (the metrics registry, spans and
device monitors are ROADMAP queue 1, item 15)."""
from repro_torch.obs.logs import (  # noqa: F401
    EventLog, JsonFormatter, setup_logging,
)
