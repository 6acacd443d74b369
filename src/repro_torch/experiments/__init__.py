"""Experiment suites of the port (``--suite sim``): scenario registry,
topology presets, artifact writers and the CLI."""
