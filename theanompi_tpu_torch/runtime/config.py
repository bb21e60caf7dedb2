"""A small attribute-dict with defaults merging — the port's own copy
of ``theanompi_tpu.runtime.config.Config`` (whose package imports
jax).  Unknown-key access raises ``AttributeError`` so typos fail
loudly."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional


class Config:
    def __init__(self, defaults: Optional[Mapping[str, Any]] = None,
                 **overrides: Any):
        d: Dict[str, Any] = dict(defaults or {})
        d.update(overrides)
        object.__setattr__(self, "_d", d)

    def __getattr__(self, k: str) -> Any:
        if k == "_d":
            raise AttributeError("_d")
        try:
            return self._d[k]
        except KeyError:
            raise AttributeError(f"config has no key {k!r}") from None

    def __getitem__(self, k: str) -> Any:
        return self._d[k]

    def __contains__(self, k: str) -> bool:
        return k in self._d

    def get(self, k: str, default: Any = None) -> Any:
        return self._d.get(k, default)

    def update(self, other: Optional[Mapping[str, Any]] = None,
               **kw: Any) -> "Config":
        if other:
            self._d.update(other)
        self._d.update(kw)
        return self

    def __repr__(self) -> str:
        return f"Config({self._d!r})"
