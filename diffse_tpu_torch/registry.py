"""Name -> class registry, the interface of ``diffse_tpu.registry``.

The port keeps its own copy of these few lines so that it runs, and
``chip_smoke.py`` drives it, without loading any module of the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Type


class Registry:
    def __init__(self, managed_thing: str):
        self.managed_thing = managed_thing
        self._registry: Dict[str, Type] = {}

    def register(self, name: str) -> Callable:
        def inner_wrapper(wrapped_class):
            if name in self._registry:
                raise ValueError(f"{self.managed_thing} with name '{name}' already registered!")
            self._registry[name] = wrapped_class
            return wrapped_class

        return inner_wrapper

    def get_by_name(self, name: str):
        if name in self._registry:
            return self._registry[name]
        raise ValueError(f"{self.managed_thing} with name '{name}' unknown! "
                         f"Available: {sorted(self._registry)}")

    def get_all_names(self):
        return list(self._registry.keys())
