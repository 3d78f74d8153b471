"""The store's object model: the port's copy of the parts of
``kubedl_tpu/core/objects.py`` that the object store and the leases use
(``new_uid`` / ``ensure_uid_floor``, ``OwnerRef``, ``ObjectMeta``,
``BaseObject``, ``match_labels``). The pod, service and node kinds belong
to the control plane, which stays the reference's.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional, Tuple

_uid_lock = threading.Lock()
_uid_next = 1


def new_uid() -> str:
    global _uid_next
    with _uid_lock:
        n = _uid_next
        _uid_next += 1
    return f"uid-{n:08d}"


def ensure_uid_floor(floor: int) -> None:
    """Advance the uid counter past ``floor``. A restarted process starts
    minting from 1 again; WAL rehydration calls this with the highest
    replayed uid so fresh objects never collide with replayed ones."""
    global _uid_next
    with _uid_lock:
        if _uid_next <= floor:
            _uid_next = floor + 1


@dataclass
class OwnerRef:
    kind: str
    name: str
    uid: str
    controller: bool = True


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_refs: List[OwnerRef] = field(default_factory=list)
    creation_timestamp: float = field(default_factory=time.time)
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0

    def controller_ref(self) -> Optional[OwnerRef]:
        for r in self.owner_refs:
            if r.controller:
                return r
        return None


@dataclass
class BaseObject:
    """Everything stored in the ObjectStore derives from this."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    KIND: ClassVar[str] = "Object"

    @property
    def kind(self) -> str:
        return self.KIND

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def key(self) -> Tuple[str, str]:
        return (self.metadata.namespace, self.metadata.name)


def match_labels(labels: Dict[str, str], selector: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())
