"""Structured metrics logging (port of ``segtpu/core/logging.py``,
copied; one JSON record per line: ``ts``, ``kind``, then the fields, with
tensors and numpy scalars turned to floats).

The reference records training progress only as formatted print lines
(train.py:198-204) and matplotlib figures. This logger writes one JSON
object per record to a JSONL file (machine-readable, resumable, append-only)
while optionally mirroring the reference's human-readable lines.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics sink."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, record: Dict[str, Any], kind: str = "metrics") -> None:
        rec = {"ts": time.time(), "kind": kind}
        rec.update({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in record.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if self.echo:
            body = ", ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                             f"{k}={v}" for k, v in rec.items()
                             if k not in ("ts", "kind"))
            print(f"[{kind}] {body}")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
