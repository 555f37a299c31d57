"""Tolerant env-knob parsing, shared by the telemetry modules.

Every ``DWT_*`` knob is ambient configuration read on a hot or
startup-critical path; a typo'd value must degrade to the default, never
raise into the serving loop (the always-on black box especially).  One
owner for that rule — ``runlog``, ``flightrecorder``, and ``anomaly``
all parse through here.
"""

from __future__ import annotations

import os


def env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default
