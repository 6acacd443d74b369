"""Training: a copy of ``repro/train`` (the trainer, checkpoints, fault
tolerance) for the unsharded case, the port having no mesh yet."""

from .checkpoint import Checkpointer
from .fault import (HeartbeatMonitor, RemeshPlan, StragglerMonitor,
                    checkpoint_cadence_steps, failure_mttf_steps,
                    plan_remesh)
from .trainer import TrainState, Trainer, compress_grads_ef

__all__ = ["Checkpointer", "HeartbeatMonitor", "RemeshPlan",
           "StragglerMonitor", "TrainState", "Trainer",
           "checkpoint_cadence_steps", "compress_grads_ef",
           "failure_mttf_steps", "plan_remesh"]
