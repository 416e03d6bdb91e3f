"""Driver logging and JSONL event streams (port of ``repro.obs.logs``).

``setup_logging()`` is the one logging entry point of the launch
drivers: a human-readable line by default, and ``json_mode=True``
(``--log-json``) one JSON object per line for log shippers.

``EventLog`` is the machine-readable record of a training run: an
append-only JSONL stream of structured events (epoch stats, checkpoint
writes, watchdog fires, resumes) written next to the checkpoints, so a
run's history survives the terminal and a dashboard can tail it live.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import IO, Optional

HUMAN_FORMAT = "%(asctime)s %(levelname).1s %(name)s :: %(message)s"
HUMAN_DATEFMT = "%H:%M:%S"


class JsonFormatter(logging.Formatter):
    """One JSON object per log record (stable key set)."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def setup_logging(level: int = logging.INFO,
                  json_mode: bool = False) -> None:
    """Configure root logging for a driver process (the last call wins:
    ``force=True`` replaces earlier handlers)."""
    if json_mode:
        handler = logging.StreamHandler()
        handler.setFormatter(JsonFormatter())
        logging.basicConfig(level=level, handlers=[handler], force=True)
    else:
        logging.basicConfig(level=level, format=HUMAN_FORMAT,
                            datefmt=HUMAN_DATEFMT, force=True)


class EventLog:
    """Append-only JSONL event stream (one flush per event).

    Each line: ``{"ts": <unix seconds>, "event": <kind>, **fields}``.
    The file parent is created on first emit; a no-path EventLog is a
    no-op sink so call sites never branch on "is event logging on".
    """

    def __init__(self, path: Optional[str]):
        self.path = path
        self._fh: Optional[IO[str]] = None

    def emit(self, event: str, **fields) -> None:
        if self.path is None:
            return
        if self._fh is None:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "a")
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
