"""Routing resilience on top of the port's graph engine (port of
``repro.routing``): :mod:`.protection` holds FatPaths-style routing
layers and MRC-style precomputed backup next-hops, so a degraded fabric
can reroute locally (table lookups, no BFS) before a global
reconvergence."""

from .protection import (LocalRerouteResult, ProtectedRouter,
                         REROUTE_MODES, validate_reroute_mode)

__all__ = ["LocalRerouteResult", "ProtectedRouter", "REROUTE_MODES",
           "validate_reroute_mode"]
