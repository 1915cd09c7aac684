"""Machine-readable progress protocol for GUI/driver consumption.

Emits `[[LUW_PROGRESS]]{json}` lines on stdout when the environment variable
LUW_PROGRESS_MODE=gui is set, with a small debounce — the same wire contract
as the reference (luw_progress.py:46-98, utilities.hpp:3126-3200) so the
existing GUI's CommandRunner can drive this framework unchanged.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

PREFIX = "[[LUW_PROGRESS]]"
DEBOUNCE_S = 0.15


class ProgressEmitter:
    def __init__(self, stage: str, stream=None):
        self.stage = stage
        self.stream = stream if stream is not None else sys.stdout
        self._last = 0.0

    @property
    def enabled(self) -> bool:
        return os.environ.get("LUW_PROGRESS_MODE", "").lower() == "gui"

    def emit(self, label: str, detail: str = "", current: int = -1,
             total: int = -1, indeterminate: Optional[bool] = None,
             force: bool = False) -> None:
        if not self.enabled:
            return
        now = time.monotonic()
        final = current >= 0 and total >= 0 and current >= total
        if not force and not final and (now - self._last) < DEBOUNCE_S:
            return
        self._last = now
        payload = {
            "stage": self.stage,
            "label": label,
            "detail": detail,
            "current": int(current),
            "total": int(total),
            "indeterminate": bool(indeterminate if indeterminate is not None
                                  else (current < 0 or total < 0)),
        }
        self.stream.write(PREFIX + json.dumps(payload) + "\n")
        self.stream.flush()

    def done(self, label: str, detail: str = "") -> None:
        self.emit(label, detail, current=1, total=1, indeterminate=False, force=True)
