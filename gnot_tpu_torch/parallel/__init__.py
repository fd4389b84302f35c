"""Parameter layouts of the port: the stacked-layer layout (``scan_layers``)."""
