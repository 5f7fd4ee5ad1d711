"""Structured JSON logging on the stdlib.

The reference uses structlog for ISO-timestamped JSON event logs at the server layer
(reference: services/tts/server.py:36-44) and stdlib logging in core modules.  structlog
is not a dependency here; this module reproduces the same surface: ``get_logger(name)``
returns a logger whose methods accept an event name plus keyword fields and emit one JSON
object per line.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Optional


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname.lower(),
            "logger": record.name,
            "event": record.getMessage(),
        }
        fields = getattr(record, "_fields", None)
        if fields:
            payload.update(fields)
        if record.exc_info and record.exc_info[0] is not None:
            payload["exception"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str)


class BoundLogger:
    """structlog-style facade: ``log.info("event_name", key=value, ...)``."""

    def __init__(self, logger: logging.Logger):
        self._logger = logger

    def _log(self, level: int, event: str, exc_info: bool = False, **fields: Any) -> None:
        if self._logger.isEnabledFor(level):
            self._logger.log(level, event, exc_info=exc_info, extra={"_fields": fields})

    def debug(self, event: str, **fields: Any) -> None:
        self._log(logging.DEBUG, event, **fields)

    def info(self, event: str, **fields: Any) -> None:
        self._log(logging.INFO, event, **fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._log(logging.WARNING, event, **fields)

    def error(self, event: str, exc_info: bool = False, **fields: Any) -> None:
        self._log(logging.ERROR, event, exc_info=exc_info, **fields)


_configured = False


def configure(level: str = "INFO", stream: Any = None, logfile: Optional[str] = None) -> None:
    """Install the JSON formatter on the root logger (idempotent re-configure)."""
    global _configured
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(_JsonFormatter())
    root.addHandler(handler)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(_JsonFormatter())
        root.addHandler(fh)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    _configured = True


def get_logger(name: str) -> BoundLogger:
    global _configured
    if not _configured:
        # Library-safe implicit setup: only claim the root logger if the HOST
        # application hasn't configured it — stripping someone else's handlers
        # from inside a get_logger call would silently kill their log files /
        # pytest captures. Explicit configure() (the service entrypoint) still
        # replaces handlers, which is what a process that owns logging wants.
        if logging.getLogger().handlers:
            _configured = True
        else:
            configure()
    return BoundLogger(logging.getLogger(name))
