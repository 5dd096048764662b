"""A small typed-config base on dataclasses (pydantic is not a dependency).

``Schema.from_dict`` builds a config from a YAML mapping with the checks the
JAX package's pydantic schemas make on the same files: unknown keys are
rejected (``extra = "forbid"``) or dropped (``"ignore"``), ``Literal`` fields
only take their listed values, ints widen to floats, nested schemas and
``name``-discriminated unions are built recursively, and a missing required
field names itself.
"""

from __future__ import annotations

import dataclasses
import typing as tp


def required():
    """A field with no default (pydantic ``Field(...)``)."""
    return dataclasses.field(default=None, metadata={"required": True})


class ConfigError(ValueError):
    pass


def _coerce(owner: str, name: str, tp_, v):
    origin = tp.get_origin(tp_)
    args = tp.get_args(tp_)
    where = f"{owner}.{name}"
    if tp_ is tp.Any:
        return v
    if origin is tp.Union:
        if v is None and type(None) in args:
            return None
        opts = [a for a in args if a is not type(None)]
        schemas = [a for a in opts if isinstance(a, type) and issubclass(a, Schema)]
        if schemas and isinstance(v, dict):
            by_name = {}
            for s in schemas:
                for lit in tp.get_args(tp.get_type_hints(s)["name"]):
                    by_name[lit] = s
            if v.get("name") not in by_name:
                raise ConfigError(f"{where}: name must be one of {sorted(by_name)}; "
                                  f"got {v.get('name')!r}")
            return by_name[v["name"]].from_dict(v)
        errors = []
        for a in opts:
            try:
                return _coerce(owner, name, a, v)
            except ConfigError as e:
                errors.append(str(e))
        raise ConfigError("; ".join(errors))
    if origin is tp.Literal:
        if v not in args:
            raise ConfigError(f"{where}: must be one of {list(args)}; got {v!r}")
        return v
    if isinstance(tp_, type) and issubclass(tp_, Schema):
        if isinstance(v, tp_):
            return v
        if not isinstance(v, dict):
            raise ConfigError(f"{where}: expected a mapping, got {v!r}")
        return tp_.from_dict(v)
    if tp_ is bool:
        if not isinstance(v, bool):
            raise ConfigError(f"{where}: expected a bool, got {v!r}")
        return v
    if tp_ is int:
        if isinstance(v, bool) or not isinstance(v, int):
            raise ConfigError(f"{where}: expected an int, got {v!r}")
        return v
    if tp_ is float:
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ConfigError(f"{where}: expected a number, got {v!r}")
        return float(v)
    if tp_ is str:
        if not isinstance(v, str):
            raise ConfigError(f"{where}: expected a string, got {v!r}")
        return v
    if origin in (list, tuple) or tp_ in (list, tuple):
        if not isinstance(v, (list, tuple)):
            raise ConfigError(f"{where}: expected a list, got {v!r}")
        if args and args[-1] is not Ellipsis and origin is tuple and len(args) == len(v):
            return tuple(_coerce(owner, name, a, x) for a, x in zip(args, v))
        return list(v) if (origin or tp_) is list else tuple(v)
    return v


@dataclasses.dataclass
class Schema:
    """Base for config dataclasses; subclasses set ``_extra``."""

    _extra: tp.ClassVar[str] = "forbid"

    @classmethod
    def from_dict(cls, data: tp.Mapping[str, tp.Any]):
        hints = tp.get_type_hints(cls)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - set(fields))
        if unknown and cls._extra == "forbid":
            raise ConfigError(f"{cls.__name__}: unknown keys {unknown}")
        kwargs = {}
        for k, f in fields.items():
            if k in data:
                kwargs[k] = _coerce(cls.__name__, k, hints[k], data[k])
            elif f.metadata.get("required"):
                raise ConfigError(f"{cls.__name__}.{k}: field required")
        obj = cls(**kwargs)
        obj.validate()
        return obj

    def validate(self) -> None:
        """Cross-field checks; raise on what the port does not serve."""

    def to_dict(self) -> tp.Dict[str, tp.Any]:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to_dict() if isinstance(v, Schema) else v
        return out
