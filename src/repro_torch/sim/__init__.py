"""Flow-level fabric simulator on torch tensors (port of ``repro.sim``):
max-min water-filling (:mod:`.fairshare`), the event loop
(:mod:`.events`), plane spraying with skew and dead-plane re-spray
(:mod:`.spray`), link / switch / plane failure injection with re-routing
and recovery curves (:mod:`.failures`) and measured collective schedules
(:mod:`.collective_sim`)."""

from .collective_sim import SIM_COLLECTIVES, simulate_collective
from .events import (BatchSimResult, FlowSimResult, FlowSpec,
                     flows_to_demands, path_latency, simulate_demands,
                     simulate_flow_batches, simulate_flows,
                     simulate_incidence)
from .failures import (DegradedGraph, FailureSpec, degrade_graph,
                       degraded_router, failure_throughput,
                       parse_failure_spec, plane_capacity_factor,
                       recovery_curve, time_to_recover)
from .fairshare import FlowIncidence, flow_incidence, max_min_rates
from .spray import SprayedSimResult, flowlet_split, simulate_sprayed

__all__ = [
    "SIM_COLLECTIVES", "simulate_collective",
    "BatchSimResult", "FlowSimResult", "FlowSpec", "flows_to_demands",
    "path_latency", "simulate_demands", "simulate_flow_batches",
    "simulate_flows", "simulate_incidence",
    "DegradedGraph", "FailureSpec", "degrade_graph", "degraded_router",
    "failure_throughput", "parse_failure_spec", "plane_capacity_factor",
    "recovery_curve", "time_to_recover",
    "FlowIncidence", "flow_incidence", "max_min_rates",
    "SprayedSimResult", "flowlet_split", "simulate_sprayed",
]
