"""Cloud telemetry: per-prediction POST (the dormant Adafruit-IO channel);
the port's copy of ``mmla_audio_tpu.analyze.telemetry``.

The reference ships `send_fruit_io` with empty credentials and commented
call sites (`record_on_pc.py:35-36, 180-185`).  Same contract here: a tiny
client that formats ``{"value": <label>, "created_at": <iso Z>}`` and POSTs
with the ``X-AIO-Key`` header; disabled unless both url and key are set.
Import of ``requests``/``urllib`` happens lazily; failures never disturb the
session loop (telemetry is fire-and-forget).
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from typing import Optional

__all__ = ["TelemetryClient"]


class TelemetryClient:
    def __init__(self, url: str = "", io_key: str = "",
                 timeout: float = 2.0):
        self.url = url
        self.io_key = io_key
        self.timeout = timeout
        self.sent = 0
        self.errors = 0

    @property
    def enabled(self) -> bool:
        return bool(self.url and self.io_key)

    def format_payload(self, value: str, time: Optional[datetime] = None) -> str:
        """send_fruit_io payload: isoformat with micros stripped + 'Z'."""
        if time is None:
            time = datetime.now(timezone.utc).replace(tzinfo=None)
        ts = time.isoformat()
        ts = ts[:-7] + "Z" if len(ts) > 19 else ts + "Z"
        return json.dumps({"value": value, "created_at": ts})

    def send(self, value: str, time: Optional[datetime] = None) -> bool:
        if not self.enabled:
            return False
        payload = self.format_payload(value, time)
        try:
            import urllib.request

            req = urllib.request.Request(
                self.url, data=payload.encode(),
                headers={"X-AIO-Key": self.io_key,
                         "Content-type": "application/json"})
            urllib.request.urlopen(req, timeout=self.timeout)
            self.sent += 1
            return True
        except Exception:
            self.errors += 1
            return False
