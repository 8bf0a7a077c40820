"""Typed, declarative parameter structs (the port's copy of ``mxnet_tpu/param.py``).

Rebuild of dmlc::Parameter (``DMLC_DECLARE_PARAMETER`` — see reference
usage e.g. src/io/iter_prefetcher.h:26-44, src/optimizer/sgd-inl.h:21-40).
Every operator / iterator / optimizer declares a ``Params`` subclass whose
fields carry type, default, range and docs.  This is the load-bearing
piece of the config system (SURVEY.md §5 "Config / flag system"): it
gives kwargs validation, auto-generated docstrings, and a serializable
``to_dict`` used for graph JSON round-trips.

Usage::

    class ConvParams(Params):
        kernel = field(tuple_of(int), required=True, doc="conv kernel size")
        num_filter = field(int, required=True, lower=1)
        stride = field(tuple_of(int), default=None, doc="defaults to 1s")
        layout = field(str, default="NCHW", enum=("NCHW", "NHWC"))

    p = ConvParams(kernel=(3, 3), num_filter=64)
"""

from __future__ import annotations

import ast

__all__ = ["Params", "field", "tuple_of", "ParamError"]

_REQUIRED = object()


class ParamError(ValueError):
    pass


class _Field:
    __slots__ = ("name", "type", "default", "enum", "lower", "upper", "doc", "required")

    def __init__(self, type_, default=_REQUIRED, enum=None, lower=None, upper=None,
                 doc="", required=False):
        self.name = None
        self.type = type_
        self.default = _REQUIRED if required else default
        self.enum = enum
        self.lower = lower
        self.upper = upper
        self.doc = doc
        self.required = required or default is _REQUIRED

    def coerce(self, value):
        if value is None:
            return None
        try:
            value = self.type(value) if not isinstance(value, _TupleOf) else self.type(value)
        except (TypeError, ValueError) as e:
            raise ParamError(f"field {self.name}: cannot convert {value!r}: {e}") from None
        if self.enum is not None and value not in self.enum:
            raise ParamError(f"field {self.name}: {value!r} not in {self.enum}")
        if self.lower is not None and value < self.lower:
            raise ParamError(f"field {self.name}: {value!r} < lower bound {self.lower}")
        if self.upper is not None and value > self.upper:
            raise ParamError(f"field {self.name}: {value!r} > upper bound {self.upper}")
        return value


def field(type_, default=_REQUIRED, enum=None, lower=None, upper=None, doc="",
          required=False):
    """Declare a typed field inside a Params subclass."""
    return _Field(type_, default, enum, lower, upper, doc, required)


class _TupleOf:
    """Coercer for tuple-valued fields; accepts tuples, lists, scalars and
    the reference's string syntax ``"(2, 2)"`` (kwargs arrive as strings
    through its C API registry; we accept the same for compat)."""

    def __init__(self, elem_type):
        self.elem_type = elem_type

    def __call__(self, value):
        if isinstance(value, str):
            value = ast.literal_eval(value)
        if not isinstance(value, (tuple, list)):
            value = (value,)
        return tuple(self.elem_type(v) for v in value)

    @property
    def __name__(self):
        return f"tuple_of({self.elem_type.__name__})"


def tuple_of(elem_type):
    return _TupleOf(elem_type)


def _coerce_bool(v):
    if isinstance(v, str):
        return v.lower() in ("1", "true", "yes")
    return bool(v)


class _ParamsMeta(type):
    def __new__(mcls, name, bases, ns):
        fields = {}
        for base in bases:
            fields.update(getattr(base, "_fields", {}))
        for key, val in list(ns.items()):
            if isinstance(val, _Field):
                val.name = key
                if val.type is bool:
                    val.type = _coerce_bool
                fields[key] = val
                del ns[key]
        ns["_fields"] = fields
        cls = super().__new__(mcls, name, bases, ns)
        if fields:
            cls.__doc__ = (cls.__doc__ or "") + "\n\nParameters\n----------\n" + "\n".join(
                f"{f.name} : {getattr(f.type, '__name__', f.type)}"
                + ("" if f.required else f", optional (default={f.default!r})")
                + (f"\n    {f.doc}" if f.doc else "")
                for f in fields.values()
            )
        return cls


class Params(metaclass=_ParamsMeta):
    """Base class for declarative parameter structs."""

    _fields: dict = {}

    def __init__(self, **kwargs):
        cls = type(self)
        for key, value in kwargs.items():
            if key not in cls._fields:
                raise ParamError(
                    f"{cls.__name__}: unknown argument {key!r}; "
                    f"valid arguments: {sorted(cls._fields)}"
                )
            object.__setattr__(self, key, cls._fields[key].coerce(value))
        for key, f in cls._fields.items():
            if key not in kwargs:
                if f.default is _REQUIRED:
                    raise ParamError(f"{cls.__name__}: missing required argument {key!r}")
                object.__setattr__(self, key, f.default)

    def to_dict(self) -> dict:
        """Non-default fields as a str->str dict (graph JSON serialization)."""
        out = {}
        for key, f in type(self)._fields.items():
            val = getattr(self, key)
            if f.default is _REQUIRED or val != f.default:
                out[key] = str(val)
        return out

    def full_dict(self) -> dict:
        return {key: getattr(self, key) for key in type(self)._fields}

    def __repr__(self):
        inner = ", ".join(f"{k}={getattr(self, k)!r}" for k in type(self)._fields)
        return f"{type(self).__name__}({inner})"

    def __eq__(self, other):
        return type(self) is type(other) and self.full_dict() == other.full_dict()

    def __hash__(self):
        return hash(tuple(sorted((k, repr(v)) for k, v in self.full_dict().items())))

    @classmethod
    def argument_names(cls):
        return list(cls._fields)
