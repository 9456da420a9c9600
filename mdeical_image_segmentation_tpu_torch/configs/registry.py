"""Name → constructor registries (the JAX package's ``configs/registry.py``).

Component names (models, slice builders) resolve through explicit
registries: a small decorator-based map per component family, greppable
instead of reflection over module paths.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional


class Registry:
    """A string → constructor map with a decorator interface.

    >>> MODELS = Registry("model")
    >>> @MODELS.register("UNet3D")
    ... class UNet3D: ...
    >>> MODELS.get("UNet3D") is UNet3D
    True
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None, *aliases: str) -> Callable:
        def deco(obj):
            key = name or obj.__name__
            for k in (key, *aliases):
                if k in self._entries and self._entries[k] is not obj:
                    raise KeyError(f"duplicate {self.kind} registration: {k!r}")
                self._entries[k] = obj
            return obj

        return deco

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {known}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> Iterable[str]:
        return sorted(self._entries)

