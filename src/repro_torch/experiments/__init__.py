"""Experiment suites of the port (``--suite table2``, ``--suite sim``,
``--suite sweep`` and ``--suite failures``): scenario registry, topology
presets, artifact writers and the CLI."""

from .sweep import run_table2_suite

__all__ = ["run_table2_suite"]
