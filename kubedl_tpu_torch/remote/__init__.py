"""The port's copy of the blob-store client (``kubedl_tpu/remote``)."""
