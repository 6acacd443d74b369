"""Experiment suites of the port (``--suite sim`` and ``--suite sweep``):
scenario registry, topology presets, artifact writers and the CLI."""
