"""Serving: dynamic request batching over the packed fleet engine and an
HTTP front end (port of diffse_tpu/serving; the ``jax.export`` artifact of
``serving/export.py`` is not ported)."""

from .service import (EnhanceService, FlightTimeout, RequestTooLarge, ServiceConfig,
                      ServiceOverloaded, flight_seed)

__all__ = ["EnhanceService", "ServiceConfig", "RequestTooLarge", "ServiceOverloaded",
           "FlightTimeout", "flight_seed"]
