"""Host utilities of the port: the JSONL metrics sink and profiler hooks."""
