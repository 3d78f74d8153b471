"""The ``Lease`` object: the port's copy of what ``kubedl_tpu/ps/shards.py``
uses of ``kubedl_tpu/core/leases.py``. A lease (holder identity, renew
timestamp, TTL) lives in the object store; its ``transitions`` counter
increments on every change of holder and is the fencing token a
parameter-service shard stamps into its writes. The leader elector that
campaigns for leases is the control plane's and stays the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

from kubedl_tpu_torch.core.objects import BaseObject

LEASE_NAMESPACE = "kubedl-system"


@dataclass
class Lease(BaseObject):
    KIND = "Lease"
    holder: str = ""
    acquired_at: float = 0.0
    renewed_at: float = 0.0
    lease_ttl: float = 5.0
    #: fencing token: bumps every time leadership changes hands
    transitions: int = 0
