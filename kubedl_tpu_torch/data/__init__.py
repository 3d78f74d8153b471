"""Host-side data plane of the port: token-file datasets (``native.py``)."""
