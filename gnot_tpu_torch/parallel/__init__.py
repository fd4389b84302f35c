"""Parameter layouts and parallelism of the port: the stacked-layer layout
(``scan_layers``), the rank mesh (``mesh.py``) and multi-process training
(``multihost.py``)."""
