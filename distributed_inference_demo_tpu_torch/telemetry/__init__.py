"""Telemetry: the pieces of the JAX package's telemetry layer the port
runs so far.

``_env`` (tolerant ``DWT_*`` knob parsing) and ``flightrecorder`` (the
bounded always-on event ring) are copies of the JAX package's modules,
which do no JAX work.  Tracing, metrics, the SLO ledger, the anomaly
monitor, profiling and postmortems are ported in a later slice.
"""

from .flightrecorder import (FlightRecorder, get_flight_recorder,
                             set_flight_recorder)

__all__ = ["FlightRecorder", "get_flight_recorder", "set_flight_recorder"]
