"""SparkML-compatible parameter system.

Counterpart of ``synapseml_tpu/core/params.py``: the same ``Param`` /
``ComplexParam`` / ``Params`` / ``GlobalParams`` / ``TypeConverters``
surface, converters and validators. ``ServiceParam`` (value-or-column
params of the services plane) comes with the port of ``services/``.
"""

from __future__ import annotations

import copy as _copy
import threading
import uuid
from typing import Any, Callable

__all__ = [
    "Param",
    "ComplexParam",
    "Params",
    "GlobalParams",
    "TypeConverters",
]


class TypeConverters:
    """Coercions applied on set(); mirrors pyspark.ml.param.TypeConverters."""

    @staticmethod
    def to_int(v):
        return int(v)

    @staticmethod
    def to_float(v):
        return float(v)

    @staticmethod
    def to_bool(v):
        if isinstance(v, str):
            return v.lower() in ("true", "1", "yes")
        return bool(v)

    @staticmethod
    def to_string(v):
        return str(v)

    @staticmethod
    def to_list(v):
        return list(v)

    @staticmethod
    def identity(v):
        return v


class Param:
    """A named, documented parameter attached to a Params class."""

    def __init__(self, name: str, doc: str = "", default: Any = None,
                 converter: Callable[[Any], Any] | None = None,
                 validator: Callable[[Any], bool] | None = None):
        self.name = name
        self.doc = doc
        self.default = default
        self.converter = converter
        self.validator = validator

    is_complex = False

    def coerce(self, value):
        if self.converter is not None and value is not None:
            value = self.converter(value)
        if self.validator is not None and value is not None and not self.validator(value):
            raise ValueError(f"invalid value for param {self.name}: {value!r}")
        return value

    def __repr__(self):
        return f"Param({self.name!r})"


class ComplexParam(Param):
    """Param whose value is not JSON-serializable (model weights, DataFrames,
    callables, estimators). Serialized out-of-band on save()."""

    is_complex = True


class _ParamsMeta(type):
    """Collects Param class attributes into a per-class registry."""

    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        registry: dict[str, Param] = {}
        for base in reversed(cls.__mro__):
            for k, v in vars(base).items():
                if isinstance(v, Param):
                    registry[k] = v
        cls._param_registry = registry
        return cls


class Params(metaclass=_ParamsMeta):
    """Base for everything with params. Generates get_X/set_X accessors
    dynamically, mirroring SparkML's ``getX``/``setX`` convention."""

    def __init__(self, uid: str | None = None, **kwargs):
        self.uid = uid or f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        self._param_values: dict[str, Any] = {}
        self.set(**kwargs)

    # -------- core accessors --------
    @classmethod
    def params(cls) -> dict[str, Param]:
        return dict(cls._param_registry)

    def has_param(self, name: str) -> bool:
        return name in self._param_registry

    def is_set(self, name: str) -> bool:
        return name in self._param_values

    def is_defined(self, name: str) -> bool:
        return self.is_set(name) or self._param_registry[name].default is not None

    def get(self, name: str, default: Any = "__raise__") -> Any:
        if name not in self._param_registry:
            if default != "__raise__":
                return default
            raise KeyError(f"{type(self).__name__} has no param {name!r}")
        if name in self._param_values:
            return self._param_values[name]
        gp = GlobalParams.get_default(type(self), name)
        if gp is not _MISSING:
            return gp
        return self._param_registry[name].default

    def set(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            if k not in self._param_registry:
                raise KeyError(f"{type(self).__name__} has no param {k!r}; "
                               f"available: {sorted(self._param_registry)}")
            self._param_values[k] = self._param_registry[k].coerce(v)
        if kwargs:
            # runtime caches live in __dict__ under "_cache_*" keys; any param
            # change invalidates them so a baked-in value can never go stale
            for key in [k for k in self.__dict__ if k.startswith("_cache_")]:
                del self.__dict__[key]
        return self

    def clear(self, name: str) -> "Params":
        self._param_values.pop(name, None)
        return self

    def __getattr__(self, item: str):
        # get_foo / set_foo sugar
        if item.startswith("get_"):
            name = item[4:]
            if name in self._param_registry:
                return lambda: self.get(name)
        elif item.startswith("set_"):
            name = item[4:]
            if name in self._param_registry:
                def setter(value, _name=name):
                    self.set(**{_name: value})
                    return self
                return setter
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {item!r}")

    # -------- lifecycle --------
    def copy(self, extra: dict | None = None) -> "Params":
        other = _copy.copy(self)
        other._param_values = dict(self._param_values)
        if extra:
            other.set(**extra)
        return other

    def explain_params(self) -> str:
        lines = []
        for name, p in sorted(self._param_registry.items()):
            cur = self.get(name)
            lines.append(f"{name}: {p.doc} (default: {p.default!r}, current: {cur!r})")
        return "\n".join(lines)

    # -------- serialization split --------
    def simple_param_values(self) -> dict:
        return {k: v for k, v in self._param_values.items()
                if not self._param_registry[k].is_complex}

    def complex_param_values(self) -> dict:
        return {k: v for k, v in self._param_values.items()
                if self._param_registry[k].is_complex}


_MISSING = object()


class GlobalParams:
    """Process-wide param defaults keyed by (class-or-ancestor, param name)."""

    _lock = threading.Lock()
    _defaults: dict[tuple[str, str], Any] = {}

    @classmethod
    def set_default(cls, klass_or_name, param_name: str, value: Any) -> None:
        key = klass_or_name if isinstance(klass_or_name, str) else klass_or_name.__name__
        with cls._lock:
            cls._defaults[(key, param_name)] = value

    @classmethod
    def get_default(cls, klass: type, param_name: str):
        with cls._lock:
            for base in klass.__mro__:
                hit = cls._defaults.get((base.__name__, param_name), _MISSING)
                if hit is not _MISSING:
                    return hit
        return _MISSING

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._defaults.clear()
