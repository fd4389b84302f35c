"""The port's benchmark harness (run it as ``python3 benchmark/run.py``)."""
