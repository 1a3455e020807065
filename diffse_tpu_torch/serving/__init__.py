"""Serving: dynamic request batching over the packed fleet engine, an HTTP
front end, and the exported enhance program (port of diffse_tpu/serving).

The names below load their modules on first use, so that importing
``serving.export`` (whose loader runs without model code) does not import
the service and the models behind it."""

import importlib

_EXPORTS = {
    "EnhanceService": "service", "ServiceConfig": "service", "RequestTooLarge": "service",
    "ServiceOverloaded": "service", "FlightTimeout": "service", "flight_seed": "service",
    "ArtifactService": "export", "load_artifact": "export", "save_artifact": "export",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
