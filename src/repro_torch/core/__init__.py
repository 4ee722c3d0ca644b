"""The paper's contribution: costing generated runtime execution plans.

The port's own copy of the reference's cost model: pure Python and numpy,
with the same arithmetic.  It imports neither ``torch`` nor ``jax`` nor the
reference package, so ``parallel``'s spawn workers never load torch.

Public API (see ``docs/ARCHITECTURE.md`` for the paper-section -> module
map and ``docs/COST_MODEL.md`` for the formulas):

  * plan IR            — :mod:`repro_torch.core.plan`
  * symbol table       — :mod:`repro_torch.core.symbols`
  * cost estimator     — :func:`repro_torch.core.costmodel.estimate` (``C(P, cc)``),
                         emitting :class:`~repro_torch.core.costmodel.ProgramTotals`
                         work totals alongside the costed tree
  * compiled-plan cost — :mod:`repro_torch.core.hlo_cost` (its data classes);
                         :func:`repro_torch.core.graph_cost.lower_and_cost`
                         traces a function and costs the ops it dispatches
  * EXPLAIN            — :func:`repro_torch.core.explain.explain`
  * plan optimizer     — :func:`repro_torch.core.planner.choose_plan` (staged beam
                         over sharding plans, memoized via
                         :class:`~repro_torch.core.costmodel.PlanCostCache`;
                         ``search="batched"`` costs one lane-vector walk
                         per structure group via
                         :func:`~repro_torch.core.planner.cost_candidates_batched`,
                         and :class:`~repro_torch.core.planner.IncrementalCoster`
                         re-costs single-knob mutations marginally)
  * dominance pool     — :class:`repro_torch.core.dominance.DominancePool`
                         (anytime-search pruning by sound lower bounds)
  * resource optimizer — :func:`repro_torch.core.resource.optimize_resources`
                         (cluster x plan co-search under step-time / $-per-
                         step / $-per-job / SLO objectives)
  * typed workloads    — :mod:`repro_torch.core.workload`
                         (:class:`~repro_torch.core.workload.TrainWorkload` /
                         :class:`~repro_torch.core.workload.ServeWorkload` /
                         :class:`~repro_torch.core.workload.Objective`)
  * serving schedules  — :func:`repro_torch.core.serving.optimize_serving`
                         ((pool x slots x plan) co-search under p99-TTFT /
                         tokens-per-$ objectives; disaggregated pools)
  * scenario sweeps    — :class:`repro_torch.core.sweep.SweepEngine`
  * calibration        — :mod:`repro_torch.core.calibration`
                         (:class:`~repro_torch.core.calibration.CalibrationProfile`
                         fitted factors, :func:`~repro_torch.core.calibration
                         .fit_profile` least squares)
  * running example    — :mod:`repro_torch.core.linreg` (paper §2, LinReg DS)
"""
from repro_torch.core.calibration import (CalibrationProfile, CalibrationSample,
                                          FitResult, features_from_totals,
                                          fit_profile, shape_class)
from repro_torch.core.cluster import (ClusterConfig, ChipSpec, CHIPS, TPU_V5E,
                                      TPU_V5P, TPU_V6E, CPU_HOST, H100_SXM,
                                      single_pod_config, multi_pod_config,
                                      single_chip_config, cpu_host_config,
                                      h100_single_config, torus_3d_config,
                                      dtype_bytes)
from repro_torch.core.costmodel import (CacheStats, CostBreakdown, CostEstimator,
                                        CostedProgram, PlanCostCache, ProgramTotals,
                                        estimate)
from repro_torch.core.explain import explain
from repro_torch.core.graph_cost import lower_and_cost
from repro_torch.core.hlo_cost import (CompiledCost, CollectiveStat,
                                       parse_collectives)
from repro_torch.core.plan import (Block, Call, Collective, Compute, CpVar,
                                   CreateVar, DataGen, ForBlock, FunctionBlock,
                                   GenericBlock, IfBlock, Instruction, IO, JitCall,
                                   P2P, ParForBlock, PipelinedLoopBlock, Program,
                                   RmVar, WhileBlock)
from repro_torch.core.dominance import DominancePool, pareto_dominates
from repro_torch.core.planner import (IncrementalCoster, PlanDecision, SearchStats,
                                      ShardingPlan, build_step_program, choose_plan,
                                      cost_candidates_batched, enumerate_plans,
                                      estimate_hbm, reference_plans,
                                      resident_components)
from repro_torch.core.resource import (DEFAULT_STEPS_PER_JOB, ClusterCandidate,
                                       ResourceDecision, ResourceSearchStats,
                                       checkpoint_bytes, checkpoint_restore_seconds,
                                       checkpoint_write_seconds,
                                       cluster_floor_time, enumerate_clusters,
                                       format_decisions, job_dollars, job_seconds,
                                       mesh_candidates, mesh_factorizations_3d,
                                       optimize_resources)
from repro_torch.core.serving import (ServingCandidate, ServingDecision,
                                      ServingScheduleCost, cost_serving_schedule,
                                      cross_pool_pairs, disaggregate,
                                      enumerate_serving_clusters, optimize_serving,
                                      serve_cell)
from repro_torch.core.symbols import MemState, SymbolTable, TensorStat
from repro_torch.core.sweep import (SweepCell, SweepEngine, format_table,
                                    rank_cells, sweep_rows)
from repro_torch.core.workload import (SERVE_WORKLOADS, LengthDistribution,
                                       Objective, ServeWorkload, TrainWorkload,
                                       as_objective)

__all__ = [
    "CalibrationProfile", "CalibrationSample", "FitResult",
    "features_from_totals", "fit_profile", "shape_class",
    "ClusterConfig", "ChipSpec", "CHIPS", "TPU_V5E", "TPU_V5P", "TPU_V6E",
    "CPU_HOST", "H100_SXM", "single_pod_config",
    "multi_pod_config", "single_chip_config", "cpu_host_config",
    "h100_single_config",
    "torus_3d_config", "dtype_bytes",
    "CacheStats", "CostBreakdown", "CostEstimator", "CostedProgram",
    "PlanCostCache", "ProgramTotals", "estimate", "explain",
    "CompiledCost", "CollectiveStat", "lower_and_cost",
    "parse_collectives", "Block", "Call", "Collective", "Compute", "CpVar",
    "CreateVar", "DataGen", "ForBlock", "FunctionBlock", "GenericBlock",
    "IfBlock", "Instruction", "IO", "JitCall", "P2P", "ParForBlock",
    "PipelinedLoopBlock", "Program",
    "RmVar", "WhileBlock", "PlanDecision", "SearchStats", "ShardingPlan",
    "build_step_program", "choose_plan", "cost_candidates_batched",
    "enumerate_plans", "estimate_hbm", "reference_plans",
    "resident_components", "IncrementalCoster", "DominancePool",
    "pareto_dominates",
    "DEFAULT_STEPS_PER_JOB", "ClusterCandidate", "ResourceDecision",
    "ResourceSearchStats", "cluster_floor_time", "enumerate_clusters",
    "format_decisions", "job_dollars", "job_seconds",
    "checkpoint_bytes", "checkpoint_restore_seconds",
    "checkpoint_write_seconds",
    "mesh_candidates", "mesh_factorizations_3d", "optimize_resources",
    "MemState", "SymbolTable", "TensorStat",
    "SweepCell", "SweepEngine", "format_table", "rank_cells", "sweep_rows",
    "ServingCandidate", "ServingDecision", "ServingScheduleCost",
    "cost_serving_schedule", "cross_pool_pairs", "disaggregate",
    "enumerate_serving_clusters", "optimize_serving", "serve_cell",
    "SERVE_WORKLOADS", "LengthDistribution", "Objective", "ServeWorkload",
    "TrainWorkload", "as_objective",
]
