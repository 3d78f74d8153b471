"""The object store, its write-ahead log and leases: the parts of
``kubedl_tpu/core`` the parameter service (``kubedl_tpu_torch/ps``)
stands on, copied so that the port imports nothing of the JAX package.

- :mod:`~kubedl_tpu_torch.core.objects`: ``ObjectMeta`` / ``BaseObject``
  and the uid counter (the pod, service and node types are the control
  plane's and stay the reference's).
- :mod:`~kubedl_tpu_torch.core.store`: the thread-safe ``ObjectStore``
  with watches and its optional write-ahead log.
- :mod:`~kubedl_tpu_torch.core.wal`: the ``<len><crc32><json>`` log; a
  log written by either package replays in the other.
- :mod:`~kubedl_tpu_torch.core.leases`: the ``Lease`` object whose
  ``transitions`` counter is a shard's fencing token.
- :mod:`~kubedl_tpu_torch.core.codec`: the store's JSON form of its
  objects (the reference's ``api/codec.py`` for the kinds stored here).
"""
