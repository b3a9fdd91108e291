"""Structured logging + metrics registry (copy of
``ransac_tpu.utils.logging`` under the ``ransac_tpu_torch`` logger)."""

from __future__ import annotations

import json
import logging
import sys
import time
from contextlib import contextmanager
from typing import Any, Dict

_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"ransac_tpu_torch.{name}")
    if not logging.getLogger("ransac_tpu_torch").handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("ransac_tpu_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    return logger


class Metrics:
    """Append-only scalar metrics registry with JSONL dump."""

    def __init__(self) -> None:
        self._records: list[Dict[str, Any]] = []

    def record(self, name: str, value: Any, **tags: Any) -> None:
        rec = {"name": name, "value": value, "time": time.time(), **tags}
        self._records.append(rec)

    def latest(self, name: str, default: Any = None) -> Any:
        for rec in reversed(self._records):
            if rec["name"] == name:
                return rec["value"]
        return default

    def all(self, name: str | None = None) -> list[Dict[str, Any]]:
        if name is None:
            return list(self._records)
        return [r for r in self._records if r["name"] == name]

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for rec in self._records:
                f.write(json.dumps(rec, default=float) + "\n")


metrics = Metrics()


@contextmanager
def timed(name: str, registry: Metrics = metrics, **tags: Any):
    """Record wall-clock seconds for a block under ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        registry.record(name, time.perf_counter() - t0, unit="s", **tags)
