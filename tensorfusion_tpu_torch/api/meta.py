"""Object metadata and the resource base class.

The port's copy of ``tensorfusion_tpu/api/meta.py``.

The tpu-fusion control plane keeps its state in typed Python resources
modeled after the reference's CRD layer (NexusGPU/tensor-fusion ``api/v1/``):
every object has metadata (name/namespace/labels/annotations/uid/
resourceVersion), a spec, and a status with phase + conditions.  A generic
dataclass serde (``to_dict``/``from_dict``) replaces Go's generated deepcopy.

Copy-on-write snapshots (docs/control-plane-scale.md): the object store
hands every reader the SAME deeply frozen snapshot instead of a private
deepcopy — ``freeze_copy`` builds one immutable copy per *write*, and
``get``/``list``/watch events share it at zero cost.  Mutating a frozen
snapshot raises :class:`FrozenResourceError`; a writer takes a private
mutable copy with ``obj.thaw()`` (``copy.deepcopy`` of a frozen object
does the same — deepcopy of a snapshot IS the thaw).
"""

from __future__ import annotations

import copy
import dataclasses
import typing
import uuid as uuid_mod
from dataclasses import dataclass, field

from ..clock import default_clock


class FrozenResourceError(TypeError):
    """Attempted mutation of a frozen store snapshot.

    Objects returned by ``store.get``/``list``/watch events (and cached
    listers built on them) are shared, deeply immutable views.  Call
    ``.thaw()`` for a private mutable copy, or use ``store.mutate()``
    for a read-modify-write."""


def _blocked(self, *a, **k):
    raise FrozenResourceError(
        "frozen store snapshot: call .thaw() on the resource for a "
        "private mutable copy (or use store.mutate())")


class FrozenDict(dict):
    """Immutable dict view inside a frozen resource snapshot."""

    __slots__ = ()
    __setitem__ = __delitem__ = _blocked
    pop = popitem = clear = update = setdefault = _blocked
    __ior__ = _blocked

    def __deepcopy__(self, memo):
        # deepcopy == thaw: a deep copy of a frozen view is mutable
        return {k: _thaw_value(v, memo) for k, v in self.items()}

    def __reduce__(self):
        return (dict, (), None, None, iter(self.items()))


class FrozenList(list):
    """Immutable list view inside a frozen resource snapshot."""

    __slots__ = ()
    __setitem__ = __delitem__ = _blocked
    append = extend = insert = remove = _blocked
    pop = clear = sort = reverse = _blocked
    __iadd__ = __imul__ = _blocked

    def __deepcopy__(self, memo):
        return [_thaw_value(v, memo) for v in self]

    def __reduce__(self):
        return (list, (), None, iter(self))


def _frozen_setattr(self, name, value):
    raise FrozenResourceError(
        f"frozen store snapshot: cannot set {type(self).__name__}."
        f"{name}; call .thaw() on the resource for a private mutable "
        f"copy (or use store.mutate())")


def _frozen_delattr(self, name):
    raise FrozenResourceError(
        f"frozen store snapshot: cannot delete {type(self).__name__}."
        f"{name}")


def _frozen_eq(self, other):
    """Field-wise equality that tolerates frozen-vs-mutable pairs (the
    dataclass-generated __eq__ requires identical classes)."""
    base = type(self)._TPF_BASE
    if not isinstance(other, base):
        return NotImplemented
    for fname in _field_names(base):
        if getattr(self, fname) != getattr(other, fname):
            return False
    return True


def _frozen_deepcopy(self, memo):
    # deepcopy of a frozen snapshot yields a private MUTABLE copy
    return _thaw_value(self, memo)


#: mutable dataclass -> generated frozen subclass (and the reverse map)
_FROZEN_CLASSES: dict = {}
_BASE_OF_FROZEN: dict = {}


def _frozen_class(cls):
    fc = _FROZEN_CLASSES.get(cls)
    if fc is None:
        fc = type("Frozen" + cls.__name__, (cls,), {
            "__setattr__": _frozen_setattr,
            "__delattr__": _frozen_delattr,
            "__eq__": _frozen_eq,
            # eq without hash would set __hash__ = None
            "__hash__": None,
            "__deepcopy__": _frozen_deepcopy,
            "_TPF_BASE": cls,
        })
        _FROZEN_CLASSES[cls] = fc
        _BASE_OF_FROZEN[fc] = cls
    return fc


def is_frozen(obj) -> bool:
    return type(obj) in _BASE_OF_FROZEN


def _freeze_value(v, memo):
    cls = type(v)
    if cls in _ATOMIC_TYPES or v is None:
        return v
    if cls in _BASE_OF_FROZEN or cls in (FrozenDict, FrozenList):
        return v                       # already frozen: share it
    if dataclasses.is_dataclass(cls):
        got = memo.get(id(v))
        if got is not None:
            return got
        new = object.__new__(_frozen_class(cls))
        memo[id(v)] = new
        d = new.__dict__              # bypass the guarded __setattr__
        for fname in _field_names(cls):
            d[fname] = _freeze_value(getattr(v, fname), memo)
        return new
    if cls is dict:
        return FrozenDict((k, _freeze_value(x, memo)) for k, x in v.items())
    if cls is list:
        return FrozenList(_freeze_value(x, memo) for x in v)
    if cls is tuple:
        return tuple(_freeze_value(x, memo) for x in v)
    if cls is set:
        return frozenset(_freeze_value(x, memo) for x in v)
    return copy.deepcopy(v)


def _thaw_value(v, memo):
    cls = type(v)
    if cls in _ATOMIC_TYPES or v is None:
        return v
    base = _BASE_OF_FROZEN.get(cls, cls)
    if dataclasses.is_dataclass(base):
        got = memo.get(id(v))
        if got is not None:
            return got
        new = object.__new__(base)
        memo[id(v)] = new
        d = new.__dict__
        for fname in _field_names(base):
            d[fname] = _thaw_value(getattr(v, fname), memo)
        return new
    if cls in (dict, FrozenDict):
        return {k: _thaw_value(x, memo) for k, x in v.items()}
    if cls in (list, FrozenList):
        return [_thaw_value(x, memo) for x in v]
    if cls is tuple:
        return tuple(_thaw_value(x, memo) for x in v)
    if cls in (set, frozenset):
        return {_thaw_value(x, memo) for x in v}
    return copy.deepcopy(v)


_ATOMIC_TYPES = frozenset({str, int, float, bool, bytes, complex})

#: class -> tuple of field names (dataclasses.fields() costs ~µs per
#: call and the serde walks hit it once per NODE; cached it is a dict
#: lookup)
_FIELDS_CACHE: dict = {}


def _field_names(cls):
    got = _FIELDS_CACHE.get(cls)
    if got is None:
        got = _FIELDS_CACHE[cls] = tuple(
            f.name for f in dataclasses.fields(cls))
    return got


#: class -> ((field name, default-or-sentinel), ...) for sparse serde
_SPARSE_PLAN: dict = {}
_NO_DEFAULT = object()


def _sparse_plan(cls):
    got = _SPARSE_PLAN.get(cls)
    if got is None:
        plan = []
        for f in dataclasses.fields(cls):
            default = f.default if f.default is not dataclasses.MISSING \
                else _NO_DEFAULT
            plan.append((f.name, default))
        got = _SPARSE_PLAN[cls] = tuple(plan)
    return got


def sparse_dict(obj) -> dict:
    """Compact dict serde: fields equal to their scalar default — and
    empty containers / all-default nested dataclasses — are omitted.
    ``from_dict`` reconstructs omitted fields as class defaults, so the
    round trip is lossless as long as load-time defaults match
    write-time defaults (true within one checkout; the store journal
    uses this — it halves encode time and bytes on default-heavy
    objects)."""
    base = _BASE_OF_FROZEN.get(type(obj), type(obj))
    out = {}
    for fname, default in _sparse_plan(base):
        v = getattr(obj, fname)
        if v is None or v == default:
            continue
        cls_v = type(v)
        if cls_v in _ATOMIC_TYPES:
            out[fname] = v
            continue
        if not v:                      # empty dict/list/tuple/set
            continue
        vbase = _BASE_OF_FROZEN.get(cls_v, cls_v)
        if dataclasses.is_dataclass(vbase):
            d = sparse_dict(v)
            if d:
                out[fname] = d
            continue
        out[fname] = _plain_value(v)
    return out


def freeze_copy(obj):
    """One-walk deeply-immutable copy of a resource object graph (the
    store's per-write snapshot; scalar leaves are shared, containers and
    dataclass nodes are rebuilt frozen)."""
    return _freeze_value(obj, {})


def thaw_copy(obj):
    """Deeply-mutable copy of a (frozen or mutable) object graph."""
    return _thaw_value(obj, {})


def _from_value(tp, value):
    """Recursively build a value of (possibly generic) type ``tp``."""
    if value is None:
        return None
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return _from_value(args[0], value) if args else value
    if origin in (list, tuple):
        (item_tp,) = typing.get_args(tp) or (typing.Any,)
        seq = [_from_value(item_tp, v) for v in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        args = typing.get_args(tp)
        val_tp = args[1] if len(args) == 2 else typing.Any
        return {k: _from_value(val_tp, v) for k, v in value.items()}
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return from_dict(tp, value)
    return value


def from_dict(cls, data: dict):
    """Construct dataclass ``cls`` from a plain dict, ignoring unknown keys."""
    if data is None:
        return None
    cls = _BASE_OF_FROZEN.get(cls, cls)   # normalize frozen subclasses
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _from_value(hints.get(f.name, typing.Any),
                                         data[f.name])
    return cls(**kwargs)


def _plain_value(v):
    cls = type(v)
    if cls in _ATOMIC_TYPES or v is None:
        return v
    base = _BASE_OF_FROZEN.get(cls, cls)
    if dataclasses.is_dataclass(base):
        return {fname: _plain_value(getattr(v, fname))
                for fname in _field_names(base)}
    if issubclass(cls, dict):
        return {k: _plain_value(x) for k, x in v.items()}
    if issubclass(cls, (list, tuple)):
        return [_plain_value(x) for x in v]
    if issubclass(cls, (set, frozenset)):
        return sorted(_plain_value(x) for x in v)
    return copy.deepcopy(v)


def to_dict(obj) -> dict:
    """Plain-dict serde of a dataclass graph.  Unlike
    ``dataclasses.asdict`` this always produces builtin dict/list
    containers even from frozen snapshots (consumers of the wire shape
    may mutate what they receive)."""
    return _plain_value(obj)


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: int = 0
    generation: int = 0
    creation_timestamp: float = 0.0
    deletion_timestamp: float = 0.0
    labels: typing.Dict[str, str] = field(default_factory=dict)
    annotations: typing.Dict[str, str] = field(default_factory=dict)
    finalizers: typing.List[str] = field(default_factory=list)
    owner_references: typing.List[str] = field(default_factory=list)  # "Kind/ns/name"


@dataclass
class Condition:
    type: str = ""
    status: str = "Unknown"  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


def set_condition(conditions: typing.List[Condition], ctype: str, status: str,
                  reason: str = "", message: str = "") -> None:
    for c in conditions:
        if c.type == ctype:
            if c.status != status:
                c.last_transition_time = default_clock().now()
            c.status, c.reason, c.message = status, reason, message
            return
    conditions.append(Condition(type=ctype, status=status, reason=reason,
                                message=message,
                                last_transition_time=default_clock().now()))


@dataclass
class Resource:
    """Base for all tpu-fusion API objects."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    KIND: typing.ClassVar[str] = "Resource"
    NAMESPACED: typing.ClassVar[bool] = False

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def key(self) -> str:
        if self.NAMESPACED:
            return f"{self.metadata.namespace}/{self.metadata.name}"
        return self.metadata.name

    def deepcopy(self):
        """Private mutable deep copy (thaws frozen snapshots)."""
        return _thaw_value(self, {})

    def thaw(self):
        """Private MUTABLE copy of this (frozen) store snapshot — the
        explicit entry into the copy-on-write write path: read a shared
        snapshot, thaw, mutate, ``store.update(...)``."""
        return _thaw_value(self, {})

    def freeze(self):
        """Deeply-immutable shared-snapshot copy (the store's per-write
        representation; see FrozenResourceError)."""
        return _freeze_value(self, {})

    def is_frozen(self) -> bool:
        return type(self) in _BASE_OF_FROZEN

    def to_dict(self) -> dict:
        d = to_dict(self)
        d["kind"] = self.KIND
        return d

    @classmethod
    def new(cls, name: str, namespace: str = "", **kwargs):
        obj = cls(**kwargs)
        obj.metadata.name = name
        obj.metadata.namespace = namespace if cls.NAMESPACED else ""
        obj.metadata.uid = uuid_mod.uuid4().hex
        obj.metadata.creation_timestamp = default_clock().now()
        return obj
