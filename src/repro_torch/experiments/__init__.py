"""Experiment suites of the port (``--suite table2``, ``sim``, ``sweep``,
``failures``, ``cosim`` and ``serving``): scenario registry, topology
presets, artifact writers and the CLI."""

from .sweep import run_table2_suite

__all__ = ["run_table2_suite"]
