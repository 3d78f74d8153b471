"""Typed object codec for the store: the port's copy of
``kubedl_tpu/api/codec.py`` for the kinds the port stores. :func:`encode`
lowers a stored dataclass to plain JSON types with its ``kind``
discriminator, :func:`decode` rebuilds one from its type hints (enums,
nested dataclasses, ``Optional`` / ``List`` / ``Dict`` / ``Tuple``), and
:func:`decode_object` dispatches on ``kind`` through a registry that
knows :class:`~kubedl_tpu_torch.core.leases.Lease` and whatever
:func:`register_kind` adds. The JSON is the reference's, so a store WAL
holding leases replays in either package.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import typing
from typing import Any, Dict, Optional, Type, Union


def to_jsonable(obj: Any) -> Any:
    """Recursively lower dataclasses / enums to plain JSON types."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {(k.value if isinstance(k, enum.Enum) else k): to_jsonable(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    return obj


def encode(obj: Any) -> Any:
    """Lower a typed object to plain JSON types. Stored objects carry
    their ``kind`` discriminator so :func:`decode_object` can round-trip."""
    data = to_jsonable(obj)
    kind = getattr(obj, "KIND", None)
    if isinstance(data, dict) and isinstance(kind, str):
        data = {"kind": kind, **data}
    return data


class DecodeError(Exception):
    pass


def _decode_value(tp: Any, data: Any, path: str) -> Any:
    """Reconstruct ``data`` as an instance of type ``tp``."""
    if data is None:
        return None

    origin = typing.get_origin(tp)

    if tp is Any or tp is None or tp is type(None):
        return data

    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:  # Optional[T]
            return _decode_value(args[0], data, path)
        # Mixed unions: try each member in order.
        last: Optional[Exception] = None
        for a in args:
            try:
                return _decode_value(a, data, path)
            except Exception as e:  # noqa: BLE001 — tries next member
                last = e
        raise DecodeError(f"{path}: no union member of {tp} accepted {data!r}") from last

    if origin in (list, tuple):
        args = typing.get_args(tp)
        if not isinstance(data, (list, tuple)):
            raise DecodeError(f"{path}: expected list, got {type(data).__name__}")
        if origin is tuple:
            if len(args) == 2 and args[1] is Ellipsis:
                return tuple(
                    _decode_value(args[0], v, f"{path}[{i}]")
                    for i, v in enumerate(data)
                )
            if not args:
                return tuple(data)
            if len(args) != len(data):
                raise DecodeError(
                    f"{path}: expected {len(args)}-tuple, got {len(data)} elements"
                )
            return tuple(
                _decode_value(a, v, f"{path}[{i}]")
                for i, (a, v) in enumerate(zip(args, data))
            )
        elem = args[0] if args else Any
        return [_decode_value(elem, v, f"{path}[{i}]") for i, v in enumerate(data)]

    if origin is dict:
        kt, vt = (typing.get_args(tp) or (Any, Any))
        if not isinstance(data, dict):
            raise DecodeError(f"{path}: expected object, got {type(data).__name__}")
        return {
            _decode_value(kt, k, f"{path}.<key>"): _decode_value(vt, v, f"{path}.{k}")
            for k, v in data.items()
        }

    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        try:
            return tp(data)
        except ValueError as e:
            raise DecodeError(f"{path}: {data!r} is not a valid {tp.__name__}") from e

    if dataclasses.is_dataclass(tp):
        return decode(tp, data, path)

    if tp is float and isinstance(data, (int, float)):
        return float(data)
    if tp is int and isinstance(data, bool):
        raise DecodeError(f"{path}: expected int, got bool")
    if tp is int and isinstance(data, float) and data.is_integer():
        return int(data)
    if isinstance(tp, type) and isinstance(data, tp):
        return data
    # Forward references that failed to resolve, typing aliases, etc.: pass
    # through rather than guessing.
    if not isinstance(tp, type):
        return data
    raise DecodeError(f"{path}: cannot decode {data!r} as {tp}")


def decode(cls: Type, data: Any, path: str = "$") -> Any:
    """Build ``cls`` (a dataclass) from a plain-JSON dict."""
    if not dataclasses.is_dataclass(cls):
        return _decode_value(cls, data, path)
    if isinstance(data, cls):
        return data
    if not isinstance(data, dict):
        raise DecodeError(f"{path}: expected object for {cls.__name__}")
    try:
        hints = typing.get_type_hints(cls)
    except Exception:  # un-importable forward refs: fall back to raw annotations
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    known = {f.name for f in dataclasses.fields(cls) if f.init}
    for key, value in data.items():
        if key in ("kind", "apiVersion") and key not in known:
            continue  # discriminators handled by decode_object
        if key not in known:
            raise DecodeError(f"{path}.{key}: unknown field for {cls.__name__}")
        kwargs[key] = _decode_value(hints.get(key, Any), value, f"{path}.{key}")
    try:
        return cls(**kwargs)
    except TypeError as e:
        raise DecodeError(f"{path}: cannot construct {cls.__name__}: {e}") from e


# ---- kind registry --------------------------------------------------------

_KINDS: Dict[str, Type] = {}
_KINDS_LOCK = threading.Lock()


def register_kind(cls: Type) -> Type:
    with _KINDS_LOCK:
        _KINDS[cls.KIND] = cls
    return cls


def _ensure_builtin_kinds() -> None:
    # leases imports the object model only, so this import is cycle-safe
    from kubedl_tpu_torch.core.leases import Lease

    with _KINDS_LOCK:
        _KINDS.setdefault(Lease.KIND, Lease)


def known_kinds() -> Dict[str, Type]:
    _ensure_builtin_kinds()
    with _KINDS_LOCK:
        return dict(_KINDS)


def decode_object(data: Dict[str, Any]):
    """Decode a full stored object, dispatching on ``data["kind"]``."""
    _ensure_builtin_kinds()
    kind = data.get("kind", "")
    with _KINDS_LOCK:
        cls = _KINDS.get(kind)
    if cls is None:
        raise DecodeError(f"unknown kind {kind!r} (known: {sorted(_KINDS)})")
    return decode(cls, data)
