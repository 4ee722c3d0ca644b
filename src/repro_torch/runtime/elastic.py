"""Elastic re-meshing: resume training on a different device count
(counterpart of ``repro.runtime.elastic``).

The paper's R3 (resource awareness) taken to its logical end: a cluster
resize is *just a re-costing* — rebuild ClusterConfig, re-run the planner,
restore the checkpoint under the new shardings, rescale data-parallel
hyperparameters.  The checkpoint store is layout-agnostic (global arrays),
so restoring onto any mesh is a placement of each leaf.

``ElasticPlan``, ``replan`` and ``_dp_degree`` are the reference's over the
port's copy of the cost model (numpy only; they decide bit for bit as the
reference does).  ``reshard`` moves a tree onto one device, or places it
on a ``DeviceMesh`` by a tree of shardings.  Nothing here imports torch
but ``reshard``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.calibration import CalibrationProfile
from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.costmodel import PlanCostCache
from repro_torch.core.planner import PlanDecision, ShardingPlan, choose_plan
from repro_torch.core.resource import (DEFAULT_STEPS_PER_JOB,
                                       mesh_candidates, optimize_resources,
                                       torus_links_for)
from repro_torch.core.workload import (Objective, ServeWorkload, TrainWorkload)


@dataclasses.dataclass
class ElasticPlan:
    cc: ClusterConfig
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    decision: PlanDecision
    lr_scale: float                 # linear-scaling rule on DP resize


def replan(arch: ArchConfig,
           shape: Union[ShapeConfig, TrainWorkload, ServeWorkload], *,
           old_cc: ClusterConfig,
           new_mesh_shape: Optional[Tuple[int, ...]] = None,
           new_mesh_axes: Optional[Tuple[str, ...]] = None,
           available_chips: Optional[int] = None,
           objective: Union[str, Objective] = "step_time",
           steps_per_job: int = DEFAULT_STEPS_PER_JOB,
           cache: Optional[PlanCostCache] = None,
           calibration: Optional[CalibrationProfile] = None,
           candidates=None) -> ElasticPlan:
    """Re-cost the program for a resized cluster.

    Pass ``new_mesh_shape`` to pin the mesh explicitly (the old behavior),
    or just ``available_chips`` — e.g. the device count that survived a
    failure — and the resource optimizer picks the best mesh factorization
    of the survivors (same chip: every (data x model) layout, the 3D-torus
    layouts on 3D-capable chips, and always at least the degenerate 1D
    all-data mesh, so prime survivor counts never strand the job) by
    ``C(P, cc)`` under ``objective``, instead of a hand-rolled dp-degree
    guess.
    ``objective="job_cost"`` (with ``steps_per_job`` for the remaining job
    length) picks the cheapest way to *finish the job* — relevant after a
    loss, when restart overheads have just been paid.

    The workload may be typed (:class:`TrainWorkload` /
    :class:`ServeWorkload`) and the objective a typed :class:`Objective`:
    a serving fleet that loses a slice replans its (pool x slots x plan)
    schedule under its traffic model, e.g. ``objective="ttft_p99"``.

    ``calibration`` attaches (or, as ``old_cc.calibration`` does by
    default, carries over) a fitted :class:`CalibrationProfile`: the
    replan is then priced under measured rates — this is the path the
    online recalibrator (:class:`repro_torch.runtime.train_loop
    .OnlineRecalibrator`) takes when drift flips the plan ranking.  Note
    ``with_mesh``/``dataclasses.replace`` preserve ``old_cc.calibration``
    on every derived config, so a calibrated job stays calibrated across
    resizes without re-passing the profile.  ``candidates`` restricts the
    plan search to a vetted plan family (a sequence of
    :class:`ShardingPlan`; plain ``ShapeConfig`` workloads only) — the
    online recalibrator passes its own family through here so the
    drift-triggered replan can never jump outside the plans operations
    has signed off on.
    """
    if calibration is not None:
        old_cc = dataclasses.replace(old_cc, calibration=calibration)
    if new_mesh_shape is not None:
        axes = new_mesh_axes or old_cc.mesh_axes
        # A pinned 3-axis mesh on a 3D-torus-capable chip gets the same
        # wrapped-ring link counts the candidate enumeration would give
        # it — both replan entry points must price identical hardware
        # identically (torus_links_for gates on the chip's fabric).
        new_cc = old_cc.with_mesh(
            new_mesh_shape, axes,
            torus_links=torus_links_for(tuple(axes), old_cc.chip,
                                        tuple(new_mesh_shape)))
        if isinstance(shape, (TrainWorkload, ServeWorkload)):
            best = optimize_resources(arch, shape, [("pinned", new_cc)],
                                      objective=objective,
                                      steps_per_job=steps_per_job,
                                      cache=cache)[0]
            decision = best.decision
        else:
            decision = choose_plan(arch, shape, new_cc, top_k=1,
                                   candidates=candidates, cache=cache)[0]
    elif available_chips is not None:
        cands = mesh_candidates(old_cc.chip, available_chips, base=old_cc)
        if not cands:
            raise ValueError(f"no candidate meshes for {available_chips} "
                             "surviving chips")
        best = optimize_resources(arch, shape, cands, objective=objective,
                                  steps_per_job=steps_per_job,
                                  cache=cache)[0]
        new_cc, decision = best.cc, best.decision
    else:
        raise ValueError("replan needs new_mesh_shape or available_chips")
    old_dp = _dp_degree(old_cc)
    new_dp = _dp_degree(new_cc)
    return ElasticPlan(new_cc, tuple(new_cc.mesh_shape),
                       tuple(new_cc.mesh_axes), decision,
                       lr_scale=new_dp / max(old_dp, 1))


def _dp_degree(cc: ClusterConfig) -> int:
    d = 1
    for ax in ("pod", "data"):
        d *= cc.axis_size(ax)
    return d


def _map_leaves(fn, tree: Any) -> Any:
    """``tree`` (nested dicts, lists, tuples and NamedTuples) with each
    other node replaced by ``fn(node)``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def reshard(tree: Any, placement: Any) -> Any:
    """Move a restored (host or other-device) tree onto ``placement``.

    ``None`` returns ``tree`` itself, as the reference does without
    shardings.  A ``torch.device`` (or its name) moves every tensor leaf
    there; other leaves stay as they are.  A tree of shardings (the
    structure of ``tree``, each leaf a ``launch.shardings.Sharding`` or a
    ``(mesh, placements)`` pair; ``None`` keeps a leaf as it is) places
    each tensor leaf on its mesh: a whole tensor keeps this rank's shard, a
    ``DTensor`` is redistributed.  Anything else raises ``TypeError``."""
    if placement is None:
        return tree
    import torch

    if isinstance(placement, (str, torch.device)):
        device = torch.device(placement)
        return _map_leaves(lambda leaf: leaf.to(device)
                           if isinstance(leaf, torch.Tensor) else leaf, tree)
    from repro_torch.checkpoint.store import _is_sharding, _place

    def place(leaf, sh):
        if sh is None or not isinstance(leaf, torch.Tensor):
            return leaf
        if not _is_sharding(sh):
            raise TypeError(f"reshard onto {sh!r}: no mesh; give a Sharding "
                            "or a (mesh, placements) pair")
        return _place(leaf, sh, leaf.device)
    return _zip_leaves(place, tree, placement)


def _zip_leaves(fn, tree: Any, shardings: Any) -> Any:
    """``fn(leaf, sharding)`` over ``tree`` and a tree of shardings of its
    structure, in which a sharding or a pair is a leaf."""
    from repro_torch.checkpoint.store import _is_sharding

    if isinstance(tree, dict) and isinstance(shardings, dict):
        return {k: _zip_leaves(fn, v, shardings.get(k))
                for k, v in tree.items()}
    if (isinstance(tree, (list, tuple)) and not _is_sharding(shardings)
            and isinstance(shardings, (list, tuple))):
        out = [_zip_leaves(fn, v, s) for v, s in zip(tree, shardings)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, shardings)
