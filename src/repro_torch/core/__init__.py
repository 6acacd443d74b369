"""Topology, routing and flow-level network model (port of ``repro.core``)."""
