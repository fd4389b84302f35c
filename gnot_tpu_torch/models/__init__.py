"""GNOT model modules of the port (``torch.nn``)."""
