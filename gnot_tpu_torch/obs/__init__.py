"""Observability of the port (``gnot_tpu/obs/``): the event and span
registry (``events``), the ``run.json`` manifest (``manifest``), host span
tracing (``tracing``), the slow-step gauge and the NaN localizer
(``health``), the train step's device-side telemetry with its buffer
(``telemetry``), and cluster tracing: trace-context propagation, clock
alignment, cross-host stitching and the flight recorder (``dtrace``).
None of it waits for the card on the hot path."""
