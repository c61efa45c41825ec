"""A tiny string → factory registry (architectures, benchmarks, tuners):
a copy of ``repro/common/registry.py``."""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(fn: T) -> T:
            if name in self._items:
                raise KeyError(f"{self.kind} '{name}' registered twice")
            self._items[name] = fn
            return fn

        return deco

    def get(self, name: str) -> T:
        if name not in self._items:
            known = ", ".join(sorted(self._items))
            raise KeyError(f"unknown {self.kind} '{name}'. known: {known}")
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._items))

    def names(self):
        return sorted(self._items)
