"""String-keyed block factory registry.

The port's ``Pothos::BlockRegistry``, separate from the JAX package's
(reference: math/Arithmetic.cpp:285-289 — registration of
"/comms/arithmetic" plus the legacy "/blocks/arithmetic" alias).
"""

from __future__ import annotations

from typing import Callable, Dict, List

_REGISTRY: Dict[str, Callable] = {}


def register_block(path: str, *aliases: str):
    """Decorator: register a factory under one or more registry paths."""

    def deco(factory: Callable) -> Callable:
        for p in (path,) + aliases:
            if p in _REGISTRY:
                raise ValueError(f"duplicate registry path {p}")
            _REGISTRY[p] = factory
        return factory

    return deco


class BlockRegistry:
    @staticmethod
    def make(path: str, *args, **kwargs):
        try:
            factory = _REGISTRY[path]
        except KeyError:
            raise KeyError(f"no block registered at {path!r}") from None
        blk = factory(*args, **kwargs)
        blk.name = f"{path}#{id(blk) & 0xFFFF:04x}"
        return blk

    @staticmethod
    def paths() -> List[str]:
        return sorted(_REGISTRY)

    @staticmethod
    def exists(path: str) -> bool:
        return path in _REGISTRY
