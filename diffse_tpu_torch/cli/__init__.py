"""Command-line entry points (port of diffse_tpu/cli)."""
