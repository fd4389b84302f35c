"""Host utilities of the port: the JSONL metrics sink, profiler hooks and
the runtime lock-order witness (``lockguard``, installed only on request)."""
