"""Process groups of the port: ``torch.distributed`` from the job's env and
the logical mesh over the ranks (``parallel/mesh.py``)."""
