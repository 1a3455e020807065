"""Backbone registry (port of diffse_tpu/models/shared.py's BackboneRegistry)."""

from __future__ import annotations

from ..registry import Registry

BackboneRegistry = Registry("Backbone")
