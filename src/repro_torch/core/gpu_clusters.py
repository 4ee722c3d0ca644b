"""The H100 cluster grid: which cluster of H100 SXM cards should run a job?

The port's counterpart of :func:`repro_torch.core.resource.enumerate_clusters`
and :func:`repro_torch.core.serving.enumerate_serving_clusters` for the card
it runs on.  Those two enumerate the reference's TPU chip table, and neither
fits a GPU: ``enumerate_clusters`` sizes a slice by ``POD_CHIPS``, which
gives any other chip a 256-chip pod, and names it through
``resource._short``, which only strips a ``tpu_`` prefix.  This module keeps
its own grid and its own ids, and leaves the mirrored modules as they are:

  * one card, mesh ``(1,)``: ``h100-1``;
  * one NVLink node of eight cards, each 2D layout that
    :func:`repro_torch.core.resource.mesh_factorizations` gives for 8
    (``h100-4x2``, ``h100-2x4``), on :data:`H100_SXM`;
  * two and four nodes, ``(p,) + node mesh`` over ``("pod", ...)``, the
    ``pod`` axis on the network between the nodes at the rate of
    :func:`repro_torch.core.cluster.h100_multi_node_config`'s chip
    (``h100-2x4x2-ib``, ...).

The serving grid serves every candidate colocated and adds the
prefill/decode split (:func:`repro_torch.core.serving.disaggregate`) of each
multi-node candidate.

**No price.**  ``H100_SXM.cost_per_chip_hour`` is 0.0: the port assumes no
price for the card.  Every dollar objective would tie at $0 on this grid, so
:func:`optimize_h100` raises for ``cost``, ``job_cost`` and
``tokens_per_dollar`` (and their aliases) instead of ranking ties.  It ranks
by ``step_time``, ``slo`` (with no price, the candidates that meet the target
by step time), ``device_seconds`` (step time x cards, which needs no price)
and, for a serving workload, ``ttft_p99``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.cluster import (H100_SXM, h100_multi_node_config,
                                      h100_node_config, h100_single_config)
from repro_torch.core.resource import (ClusterCandidate, ResourceDecision,
                                       mesh_factorizations, optimize_resources)
from repro_torch.core.serving import (ServingCandidate, ServingDecision,
                                      disaggregate, optimize_serving)
from repro_torch.core.workload import (OBJECTIVE_ALIASES, Objective,
                                       ServeWorkload, TrainWorkload)

# Cards on one NVLink/NVSwitch baseboard.
NODE_CARDS = H100_SXM.ici_domain

# Canonical objective kinds that rank by a price.
DOLLAR_OBJECTIVES = ("cost", "job_cost", "tokens_per_dollar")


def _mesh_id(mesh) -> str:
    return "x".join(map(str, mesh))


def enumerate_h100_clusters(node_counts: Sequence[int] = (1, 2, 4),
                            mesh_variants: int = 2
                            ) -> List[ClusterCandidate]:
    """The H100 grid: one card, then each node count's layouts (see the
    module docstring).  A node count of 1 is one NVLink node; above 1 the
    nodes are joined over the network."""
    single = h100_single_config()
    node = h100_node_config()
    multi = h100_multi_node_config()
    out = [ClusterCandidate(f"h100-{_mesh_id(single.mesh_shape)}", single)]
    for p in node_counts:
        for mesh, axes in mesh_factorizations(NODE_CARDS, mesh_variants):
            if p == 1:
                out.append(ClusterCandidate(f"h100-{_mesh_id(mesh)}",
                                            node.with_mesh(mesh, axes)))
            else:
                full = (p,) + mesh
                out.append(ClusterCandidate(
                    f"h100-{_mesh_id(full)}-ib",
                    multi.with_mesh(full, ("pod",) + axes)))
    return out


def enumerate_h100_serving_clusters(node_counts: Sequence[int] = (1, 2, 4),
                                    mesh_variants: int = 2
                                    ) -> List[ServingCandidate]:
    """Every :func:`enumerate_h100_clusters` candidate served colocated, and
    the prefill/decode split of each multi-node candidate (``...-ib+pd``)."""
    out: List[ServingCandidate] = []
    for cand in enumerate_h100_clusters(node_counts, mesh_variants):
        out.append(ServingCandidate(cand.cid, cand.cc, cand.cc))
        split = disaggregate(cand)
        if split is not None:
            out.append(split)
    return out


def check_objective(objective: Union[str, Objective]) -> str:
    """The objective's spelling, or a ``ValueError`` for one that ranks by
    a price: the card has none."""
    spelled = objective.kind if isinstance(objective, Objective) \
        else str(objective)
    if spelled != "device_seconds" \
            and OBJECTIVE_ALIASES.get(spelled) in DOLLAR_OBJECTIVES:
        raise ValueError(
            f"objective {spelled!r} ranks by price, but "
            f"H100_SXM.cost_per_chip_hour is {H100_SXM.cost_per_chip_hour} "
            f"(no price is assumed for the card); rank the H100 grid by "
            f"step_time, slo, device_seconds or ttft_p99")
    return spelled


def optimize_h100(arch: ArchConfig,
                  shape: Union[ShapeConfig, TrainWorkload, ServeWorkload],
                  clusters: Optional[Sequence] = None,
                  objective: Union[str, Objective, None] = None,
                  slo: Optional[float] = None, **kw
                  ) -> List[Union[ResourceDecision, ServingDecision]]:
    """``optimize_resources`` / ``optimize_serving`` over the H100 grid (by
    default :func:`enumerate_h100_clusters`, or the serving grid for a
    :class:`ServeWorkload`).  The default objective is ``step_time`` for a
    train shape and ``ttft_p99`` for a serving workload.

    ``device_seconds`` is, in the mirrored resource module, an alias of the
    $-per-step objective, which would tie at $0 here.  It is ranked instead
    by step time x cards: every candidate is costed (no cluster pruning by
    the step-time floor, which does not bound device-seconds), each with its
    fastest plan, which on a fixed card count is also its fewest
    device-seconds."""
    serving = isinstance(shape, ServeWorkload)
    if objective is None:
        objective = "ttft_p99" if serving else "step_time"
    spelled = check_objective(objective)
    if serving:
        grid = (clusters if clusters is not None
                else enumerate_h100_serving_clusters())
        return optimize_serving(arch, shape, grid, objective=objective,
                                slo=slo, **kw)
    grid = clusters if clusters is not None else enumerate_h100_clusters()
    if spelled != "device_seconds":
        return optimize_resources(arch, shape, grid, objective=objective,
                                  slo=slo, **kw)
    kw["prune"] = False
    out = optimize_resources(arch, shape, grid, objective="step_time", **kw)
    out.sort(key=lambda rd: (0 if rd.feasible else 1, rd.device_seconds,
                             rd.time, rd.cluster_id))
    return out
