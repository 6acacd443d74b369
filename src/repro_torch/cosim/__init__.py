"""Training-step co-simulation on the port's fabric simulator (port of
``repro.cosim``).

Derives the collective traffic of one training step (DP / TP / EP
all-reduce, all-gather, MoE all-to-all) from a model config's sharding
(:mod:`.traffic`, or from a parsed collective accounting through
:func:`~.traffic.phases_from_collectives`), maps ranks onto NICs and
switches (:mod:`.placement`), and runs the step's collective schedule on
:mod:`repro_torch.sim` as sprayed, plane-split flows with staggered
start times (:mod:`.stepsim`): a *measured* step time and tokens/sec per
topology.
"""

from .placement import (RING_STEPS, MappedLayout, group_members,
                        mphx_rank_layout, phase_step_flows, rank_to_switch)
from .stepsim import (PHASE_METHODS, PhaseTime, StepResult,
                      analytic_phase_time, simulate_step)
from .traffic import (PHASE_KINDS, CollectivePhase, TrainJob,
                      decompose_phase, job_from_model,
                      phases_from_collectives)

__all__ = [
    "RING_STEPS", "MappedLayout", "group_members", "mphx_rank_layout",
    "phase_step_flows", "rank_to_switch",
    "PHASE_METHODS", "PhaseTime", "StepResult", "analytic_phase_time",
    "simulate_step",
    "PHASE_KINDS", "CollectivePhase", "TrainJob", "decompose_phase",
    "job_from_model", "phases_from_collectives",
]
