"""Collective traffic of one training step, derived from sharding (port
of ``repro/cosim/traffic.py``).

A :class:`TrainJob` is the co-simulator's unit of work: the model's
per-step collective *phases* (gradient all-reduce on the data axis,
activation all-gather / reduce-scatter on the tensor axis, MoE token
all-to-all on the expert axis) with exact byte counts, participant group
sizes and rank strides.  Two constructors:

* :func:`job_from_model`: analytic, from a :class:`ModelConfig` and its
  mesh split (phase-resolved, so each collective runs on the fabric
  separately);
* :func:`phases_from_collectives`: from an already parsed dict of
  per-kind, per-group-size wire bytes (the accounting of an HLO
  collective parser), so the co-simulation can replay what a compiler
  emitted.

Byte semantics per kind (those of :mod:`repro_torch.core.netsim`):
``allreduce``, the full tensor a rank; ``allgather`` / ``reducescatter``,
the per-rank shard; ``alltoall``, the total *off-rank* bytes each rank
injects (the ``(g-1)/g`` share of its dispatch tensor).

Host arithmetic on Python numbers: nothing here touches a tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..configs.base import LM_SHAPES, ModelConfig, ShapeConfig

PHASE_KINDS = ("allreduce", "allgather", "reducescatter", "alltoall")

_HLO_KINDS = {
    "all-reduce": "allreduce",
    "all-gather": "allgather",
    "reduce-scatter": "reducescatter",
    "all-to-all": "alltoall",
}


@dataclass(frozen=True)
class CollectivePhase:
    """One dependent collective phase of the training step.

    The ``n_ranks // (size * stride)`` x ``stride`` concurrent groups
    tile the rank space: group ``(outer, inner)`` holds ranks
    ``outer*size*stride + inner + k*stride`` for ``k < size``, the
    standard mesh-axis layout (a fastest-varying axis has stride 1).
    """

    name: str                 # e.g. "dp_grad_allreduce"
    kind: str                 # one of PHASE_KINDS
    size: int                 # participants per group
    stride: int               # rank stride between group members
    bytes_per_rank: float     # per participating rank per call (see above)
    calls: int = 1            # issues per training step

    def __post_init__(self):
        if self.kind not in PHASE_KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; "
                             f"known: {PHASE_KINDS}")
        if self.size < 2:
            raise ValueError(f"phase {self.name}: group size must be >= 2")

    def wire_bytes_per_rank(self) -> float:
        """Bytes each rank injects per call (ring / direct algorithm)."""
        m, b = self.size, self.bytes_per_rank
        if self.kind == "allreduce":
            return 2 * (m - 1) / m * b
        if self.kind in ("allgather", "reducescatter"):
            return (m - 1) * b
        return b  # alltoall: bytes_per_rank IS the injected total


@dataclass(frozen=True)
class TrainJob:
    """One model x shape x mesh cell ready for fabric co-simulation."""

    arch: str
    n_ranks: int
    mesh: dict                       # axis name -> size (dp/tp/ep)
    tokens_per_step: int
    active_params: int               # for the compute-time term
    phases: tuple = field(default_factory=tuple)

    def __post_init__(self):
        for ph in self.phases:
            span = ph.size * ph.stride
            if self.n_ranks % span:
                raise ValueError(
                    f"phase {ph.name}: size*stride {span} does not tile "
                    f"{self.n_ranks} ranks")

    def total_wire_bytes(self) -> float:
        return sum(ph.calls * self.n_ranks * ph.wire_bytes_per_rank()
                   for ph in self.phases)


def _dtype_bytes(cfg: ModelConfig) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}.get(
        cfg.activation_dtype, 2)


def job_from_model(cfg: ModelConfig, dp: int, tp: int = 1, ep: int = 1,
                   shape: "ShapeConfig | str" = "train_4k",
                   param_count: "int | None" = None,
                   active_params: "int | None" = None) -> TrainJob:
    """Analytic per-step collective phases of ``cfg`` on a dp x tp mesh.

    ``tp`` is the fastest-varying axis (stride 1, so TP groups pack onto
    as few switches as possible), ``dp`` strides over it; ``ep`` is the
    fastest-varying sub-axis of ``dp`` (stride ``tp``) and must divide
    both ``dp`` and the expert count.  ``param_count`` /
    ``active_params`` override the counts of the model built on the meta
    device.

    Accounting per step (Megatron-style sequence-parallel training):

    * TP: one activation all-gather and one reduce-scatter per layer per
      pass, ``2 * n_layers`` calls each, shard ``tokens_per_rank *
      d_model`` activation bytes;
    * EP: dispatch and combine all-to-all per MoE layer per pass, ``2 *
      n_moe_layers`` calls, each rank sends ``tokens_per_rank * top_k *
      d_model`` bytes;
    * DP: one bucketed gradient all-reduce of the rank's parameter shard
      (``params / tp`` after the tensor-parallel split).
    """
    if isinstance(shape, str):
        shape = LM_SHAPES[shape]
    if not shape.is_train:
        raise ValueError(f"co-sim models train steps, got {shape.shape_id}")
    n_ranks = dp * tp
    if ep > 1 and dp % ep:
        raise ValueError(f"ep={ep} must divide dp={dp}")
    moe = cfg.moe
    if moe is not None and ep > 1 and moe.n_experts % ep:
        raise ValueError(f"ep={ep} must divide n_experts={moe.n_experts}")
    if param_count is None:
        param_count = cfg.param_count()
    if active_params is None:
        active_params = (cfg.active_param_count() if moe is not None
                         else param_count)
    act_bytes = _dtype_bytes(cfg)
    tokens = shape.seq_len * shape.global_batch
    tokens_per_rank = tokens / n_ranks
    phases = []
    if tp > 1:
        shard = tokens_per_rank * cfg.d_model * act_bytes
        phases.append(CollectivePhase(
            "tp_act_allgather", "allgather", tp, 1, shard,
            calls=2 * cfg.n_layers))
        phases.append(CollectivePhase(
            "tp_act_reducescatter", "reducescatter", tp, 1, shard,
            calls=2 * cfg.n_layers))
    if moe is not None and ep > 1:
        n_moe_layers = cfg.n_layers - moe.first_k_dense
        dispatch = tokens_per_rank * moe.top_k * cfg.d_model * act_bytes
        phases.append(CollectivePhase(
            "ep_token_alltoall", "alltoall", ep, tp,
            (ep - 1) / ep * dispatch, calls=2 * n_moe_layers))
    if dp > 1:
        phases.append(CollectivePhase(
            "dp_grad_allreduce", "allreduce", dp, tp,
            param_count * 2 / tp, calls=1))
    return TrainJob(cfg.arch_id, n_ranks, {"dp": dp, "tp": tp, "ep": ep},
                    tokens, int(active_params), tuple(phases))


def decompose_phase(phase: CollectivePhase,
                    chain: "list[tuple[int, int]]"
                    ) -> "list[CollectivePhase]":
    """Hierarchical split of a ring phase across placement levels.

    ``chain`` lists the axis's level factors as ``(factor, rank_stride)``
    in fastest-varying order (:class:`~repro_torch.cosim.placement.
    MappedLayout`).  A flat ring over an axis split across levels would
    cross switches on almost every step; the hierarchical schedule runs
    one sub-collective per level instead: all-gather grows its shard
    level by level, reduce-scatter shrinks it mirror-wise, all-reduce is
    the RS-down / AG-up ladder, moving the same wire bytes in fewer,
    better-localized steps.  All-to-all and single-level chains pass
    through unchanged.
    """
    fs = [f for f, _ in chain]
    if math.prod(fs) != phase.size:
        raise ValueError(f"chain {fs} does not factor group {phase.size}")
    if len(chain) <= 1 or phase.kind == "alltoall":
        return [phase]
    subs = []
    if phase.kind == "allgather":
        shard = phase.bytes_per_rank
        for i, (f, stride) in enumerate(chain):
            subs.append(CollectivePhase(
                f"{phase.name}_l{i}", "allgather", f, stride, shard,
                calls=phase.calls))
            shard *= f
    elif phase.kind == "reducescatter":
        # mirror of allgather: outermost level first, shrinking output
        inp = phase.size * phase.bytes_per_rank
        for i, (f, stride) in reversed(list(enumerate(chain))):
            inp /= f
            subs.append(CollectivePhase(
                f"{phase.name}_l{i}", "reducescatter", f, stride, inp,
                calls=phase.calls))
    else:  # allreduce: RS down the hierarchy, AG back up
        out = phase.bytes_per_rank
        for i, (f, stride) in enumerate(chain):
            out /= f
            subs.append(CollectivePhase(
                f"{phase.name}_rs_l{i}", "reducescatter", f, stride, out,
                calls=phase.calls))
        for i, (f, stride) in reversed(list(enumerate(chain))):
            subs.append(CollectivePhase(
                f"{phase.name}_ag_l{i}", "allgather", f, stride, out,
                calls=phase.calls))
            out *= f
    return subs


def phases_from_collectives(parsed: dict, device_count: int,
                            calls: int = 1) -> "list[CollectivePhase]":
    """Phases from a parsed per-kind wire accounting.

    ``parsed`` maps an HLO collective kind (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``) to ``{"count":
    n, "by_group": {group size (str): wire bytes a rank}}``.  Each (kind,
    group size) bucket becomes one phase; per-rank payloads come from
    inverting the ring wire formulas.  The group stride is unknown from
    a flat parse, so groups are taken contiguous (stride 1).
    ``collective-permute`` rows carry no group structure and are
    skipped.
    """
    out = []
    for hlo_kind, kind in _HLO_KINDS.items():
        rec = parsed.get(hlo_kind)
        if not rec or not rec.get("count"):
            continue
        for g_str, wire in sorted(rec["by_group"].items(),
                                  key=lambda kv: int(kv[0])):
            g = int(g_str)
            if g < 2 or wire <= 0:
                continue
            if kind == "allreduce":
                per_rank = wire * g / (2 * (g - 1))
            elif kind in ("allgather", "reducescatter"):
                per_rank = wire / (g - 1)
            else:
                per_rank = wire  # alltoall wire IS the off-rank total
            if device_count % g:
                raise ValueError(
                    f"group size {g} does not divide {device_count} devices")
            out.append(CollectivePhase(
                f"hlo_{kind}_g{g}", kind, g, 1, per_rank, calls=calls))
    return out
