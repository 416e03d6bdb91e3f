"""JSONL event streams (port of ``EventLog`` from ``repro.obs.logs``).

``EventLog`` is the machine-readable record of a training run: an
append-only JSONL stream of structured events (epoch stats, checkpoint
writes, watchdog fires, resumes) written next to the checkpoints, so a
run's history survives the terminal and a dashboard can tail it live.
"""
from __future__ import annotations

import json
import os
import time
from typing import IO, Optional


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
