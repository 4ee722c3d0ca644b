"""The port's copy of the cost model (``repro_torch.core``) against the
reference's (``repro.core``), bit for bit: the same inputs through both
packages in one process, compared with ``==`` on floats and strings
(tolerance 0).  Architectures the port has not registered are built as the
port's own ``ArchConfig`` from the reference's, field by field."""
import ast
import dataclasses
import json
from pathlib import Path

import pytest

import repro.configs as ref_configs
import repro.core as ref
from repro.core import linreg as ref_linreg
from repro.core import planner as ref_planner
from repro.core import resource as ref_resource
from repro.core import serving as ref_serving
from repro.core import sweep as ref_sweep
import repro_torch.configs as port_configs
import repro_torch.configs.base as port_base
import repro_torch.core as port
from repro_torch.core import linreg as port_linreg
from repro_torch.core import planner as port_planner
from repro_torch.core import resource as port_resource
from repro_torch.core import serving as port_serving
from repro_torch.core import sweep as port_sweep

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
PORTED = ("qwen1.5-0.5b", "mamba2-1.3b", "zamba2-2.7b")
CLUSTER_PRESETS = ("single_chip_config", "single_pod_config",
                   "multi_pod_config", "cpu_host_config")
# The reference accuracy benchmark's CPU scenarios (its CPU_SCENARIOS).
CPU_SIZES = (("cpu-S", 20_000, 256), ("cpu-M", 80_000, 384),
             ("cpu-L", 160_000, 512))
LINREG_CASES = ([(name, None, None) for name in ref_linreg.SCENARIOS]
                + list(CPU_SIZES))


def to_port(obj):
    """The port's instance of a reference config dataclass (nested ones
    included), built from its fields."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(port_base, type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_port(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj


def arch_pair(arch_id):
    ref_cfg = ref_configs.get_config(arch_id)
    port_cfg = to_port(ref_cfg)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
    return ref_cfg, port_cfg


def costed_view(costed, explain):
    """Everything an estimate reports: total, breakdown, peak HBM, work
    totals and the EXPLAIN text."""
    t = costed.totals
    return (costed.total, dataclasses.asdict(costed.breakdown),
            costed.peak_hbm_per_device,
            (dict(t.mxu_flops), t.vpu_flops, t.hbm_bytes, t.ici_bytes,
             t.dcn_bytes),
            explain(costed))


def decision_view(d):
    return (d.plan.describe(), dataclasses.asdict(d.plan), d.time,
            dataclasses.asdict(d.cost.breakdown), d.hbm_est, d.feasible)


def linreg_scenario(mod, name, m, n):
    if m is None:
        return mod.SCENARIOS[name]
    return mod.Scenario(name, m, n, dtype="float64")


@pytest.mark.parametrize("preset", CLUSTER_PRESETS)
@pytest.mark.parametrize("name,m,n", LINREG_CASES)
def test_linreg_plans_and_costs_equal_the_reference(name, m, n, preset):
    ref_cc = getattr(ref, preset)()
    port_cc = getattr(port, preset)()
    assert ref_cc.fingerprint() == port_cc.fingerprint()
    for budgets in ("PAPER_BUDGETS", "tpu_budgets"):
        ref_b = getattr(ref_linreg, budgets)
        port_b = getattr(port_linreg, budgets)
        if callable(ref_b):
            ref_b, port_b = ref_b(ref_cc), port_b(port_cc)
        assert dataclasses.asdict(ref_b) == dataclasses.asdict(port_b)
        ref_prog, ref_choice = ref_linreg.build_linreg_program(
            linreg_scenario(ref_linreg, name, m, n), ref_cc, ref_b)
        port_prog, port_choice = port_linreg.build_linreg_program(
            linreg_scenario(port_linreg, name, m, n), port_cc, port_b)
        assert dataclasses.asdict(ref_choice) == dataclasses.asdict(
            port_choice)
        assert costed_view(ref.estimate(ref_prog, ref_cc), ref.explain) == \
            costed_view(port.estimate(port_prog, port_cc), port.explain)


@pytest.mark.parametrize("cluster", ["pod", "v5p-3d"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch_id", PORTED)
def test_step_program_estimates_equal_the_reference(arch_id, shape, cluster):
    ref_cfg, port_cfg = arch_pair(arch_id)
    ref_cc, port_cc = ref_sweep.CLUSTERS[cluster], port_sweep.CLUSTERS[cluster]
    for fusion in ("off", "none", "full"):
        kw = dict(name="dp+tp", batch_axes=("data",), tp_axes=("model",),
                  fusion=fusion)
        ref_prog = ref_planner.build_step_program(
            ref_cfg, ref_configs.SHAPES[shape], ref.ShardingPlan(**kw),
            ref_cc)
        port_prog = port_planner.build_step_program(
            port_cfg, port_configs.SHAPES[shape], port.ShardingPlan(**kw),
            port_cc)
        assert costed_view(ref.estimate(ref_prog, ref_cc), ref.explain) == \
            costed_view(port.estimate(port_prog, port_cc), port.explain)


@pytest.mark.parametrize("fusion", ["off", "full"])
@pytest.mark.parametrize("cluster", ["pod", "v5p-3d"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch_id", PORTED)
def test_choose_plan_ranks_equal_the_reference(arch_id, shape, cluster,
                                               fusion):
    ref_cfg, port_cfg = arch_pair(arch_id)
    ref_top = ref.choose_plan(ref_cfg, ref_configs.SHAPES[shape],
                              ref_sweep.CLUSTERS[cluster], fusion=fusion)
    port_top = port.choose_plan(port_cfg, port_configs.SHAPES[shape],
                                port_sweep.CLUSTERS[cluster], fusion=fusion)
    assert len(ref_top) == len(port_top) > 0
    assert [decision_view(d) for d in ref_top] == \
        [decision_view(d) for d in port_top]


def _golden_grid():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "regen_sweep_golden", GOLDEN / "regen_sweep_golden.py")
    regen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(regen)
    return regen


def _cells(cells):
    out = {}
    for c in cells:
        d = c.decision
        out[c.key] = {"plan": d.plan.describe(), "step_time_s": d.time,
                      "hbm_est_bytes": d.hbm_est, "feasible": d.feasible}
    return out


@pytest.mark.parametrize("by", ["name", "config"])
def test_sweep_reproduces_the_golden_cells(by):
    """The port's SweepEngine over the golden grid equals
    tests/golden/sweep_golden.json cell for cell: by name over the ported
    archs, and by ArchConfig over all of them."""
    regen = _golden_grid()
    golden = json.loads((GOLDEN / "sweep_golden.json").read_text())
    engine = port.SweepEngine(search="beam")
    if by == "name":
        train = [a for a in regen.GOLDEN_ARCHS if a in PORTED]
        serve = [a for a in regen.GOLDEN_SERVE_ARCHS if a in PORTED]
    else:
        train = [arch_pair(a)[1] for a in regen.GOLDEN_ARCHS]
        serve = [arch_pair(a)[1] for a in regen.GOLDEN_SERVE_ARCHS]
    cells = engine.sweep(train, regen.GOLDEN_SHAPES, regen.GOLDEN_CLUSTERS)
    cells += engine.sweep(serve, regen.GOLDEN_SERVE_WORKLOADS,
                          regen.GOLDEN_CLUSTERS)
    got = _cells(cells)
    want = {k: v for k, v in golden.items() if k.split("|")[0] in
            {c if isinstance(c, str) else c.name for c in train + serve}}
    assert len(got) == len(want) == (30 if by == "name" else 60)
    assert got == want


def test_sweep_with_two_workers_equals_one():
    grid = (("qwen1.5-0.5b", "mamba2-1.3b"), ("train_4k", "decode_32k"),
            ("pod", "2pod"))
    serial = _cells(port.SweepEngine(search="beam").sweep(*grid))
    par_engine = port.SweepEngine(search="beam", jobs=2)
    par_cells = par_engine.sweep(*grid)
    assert _cells(par_cells) == serial
    assert len(serial) == 8 and all(c.worker >= 0 for c in par_cells)


def test_optimize_resources_equals_the_reference():
    ref_cfg, port_cfg = arch_pair("qwen1.5-0.5b")
    ref_cands = ref_resource.enumerate_clusters()[:8]
    port_cands = port_resource.enumerate_clusters()[:8]
    assert [c.cid for c in ref_cands] == [c.cid for c in port_cands]

    def view(out, fmt):
        return ([(rd.cluster_id, rd.pruned, rd.floor_time, rd.time,
                  rd.job_seconds, rd.cost_per_job,
                  None if rd.decision is None else decision_view(rd.decision))
                 for rd in out], fmt(out))

    ref_out = ref_resource.optimize_resources(
        ref_cfg, ref_configs.SHAPES["train_4k"], ref_cands,
        objective="job_cost")
    port_out = port_resource.optimize_resources(
        port_cfg, port_configs.SHAPES["train_4k"], port_cands,
        objective="job_cost")
    assert view(ref_out, ref_resource.format_decisions) == \
        view(port_out, port_resource.format_decisions)


def test_optimize_serving_equals_the_reference():
    ref_cfg, port_cfg = arch_pair("qwen1.5-0.5b")
    names = ("pod", "v5p-pod", "2pod")

    def view(out, fmt):
        return ([(sd.cluster_id, sd.slots, sd.pruned, sd.time, sd.ttft_p99,
                  sd.feasible,
                  None if sd.decode_decision is None
                  else decision_view(sd.decode_decision),
                  None if sd.prefill_decision is None
                  else decision_view(sd.prefill_decision))
                 for sd in out], fmt(out))

    ref_out = ref_serving.optimize_serving(
        ref_cfg, ref.SERVE_WORKLOADS["chat_2k"],
        [ref_sweep.CLUSTERS[n] for n in names])
    port_out = port_serving.optimize_serving(
        port_cfg, port.SERVE_WORKLOADS["chat_2k"],
        [port_sweep.CLUSTERS[n] for n in names])
    assert view(ref_out, ref_serving.format_serving_decisions) == \
        view(port_out, port_serving.format_serving_decisions)


HLO_SAMPLE = """
ENTRY %main {
  %p0 = bf16[256,1024]{1,0} parameter(0)
  %mul = bf16[256,1024]{1,0} multiply(%p0, %p0)
  %all-gather = bf16[4096,1024]{1,0} all-gather(%mul), replica_groups=[16,16]<=[256], dimensions={0}
  %all-reduce = f32[1024]{0} all-reduce(%conv), channel_id=2, replica_groups=[2,128]<=[256], to_apply=%region_0
  %rs = bf16[16,1024]{1,0} reduce-scatter(%mul), channel_id=3, replica_groups={{0,1,2,3}}, dimensions={0}
  %a2a = f8e4m3fn[256,1024]{1,0} all-to-all(%mul), replica_groups=[4,64]<=[256]
  %cp-start = bf16[256,1024]{1,0} collective-permute-start(%mul), source_target_pairs={{0,1}}
  %cp-done = bf16[256,1024]{1,0} collective-permute-done(%cp-start)
}
"""


@pytest.mark.parametrize("cluster", ["pod", "2pod", "v5p-3d"])
def test_compiled_cost_records_equal_the_reference(cluster):
    """The data side of costing a compiled plan: parsed collectives, the
    roofline, the time of one call, and a JitCall costed in a program."""
    ref_cc, port_cc = ref_sweep.CLUSTERS[cluster], port_sweep.CLUSTERS[cluster]
    rec = {}
    for mod, cc in ((ref, ref_cc), (port, port_cc)):
        colls = mod.parse_collectives(HLO_SAMPLE)
        cost = mod.CompiledCost("step", 3.1e12, 2.4e10, colls,
                                cc.num_chips, argument_bytes=1e9,
                                dispatch_count=3)
        assert mod.CompiledCost.from_json(cost.to_json()) == cost
        prog = mod.Program(name="jit")
        prog.blocks.append(mod.GenericBlock("call"))
        prog.blocks[0].children.append(mod.JitCall("step", cost))
        rec[mod] = ([dataclasses.asdict(c) for c in colls], cost.to_json(),
                    cost.roofline(cc),
                    dataclasses.asdict(cost.time_breakdown(cc)),
                    costed_view(mod.estimate(prog, cc), mod.explain))
    assert rec[ref] == rec[port]


def test_exports_equal_the_reference_but_the_lowering():
    """The same public names, less ``from_compiled`` (it reads a jax
    executable) and plus the port's one H100 chip and preset;
    ``lower_and_cost`` is the port's own, from ``graph_cost``, not from the
    copy of ``hlo_cost``."""
    assert set(port.__all__) == (set(ref.__all__) - {"from_compiled"}
                                 | {"H100_SXM", "h100_single_config"})
    from repro_torch.core import graph_cost, hlo_cost
    assert not hasattr(hlo_cost, "from_compiled")
    assert not hasattr(hlo_cost, "lower_and_cost")
    assert port.lower_and_cost is graph_cost.lower_and_cost


# What the port's copy may hold that the reference's module does not, or
# the other way round, by top-level name (``module:name`` for an imported
# name): the H100 chip and preset, and not the two functions that lower a
# jitted step (the port's ``lower_and_cost`` comes from ``graph_cost``).
# Nothing else may differ but docstrings and line breaks.
MIRROR_DIFFERS = {
    "cluster": {"H100_SXM", "h100_single_config", "h100_node_config",
                "h100_multi_node_config"},
    "hlo_cost": {"from_compiled", "lower_and_cost"},
    "__init__": {"repro_torch.core.cluster:H100_SXM",
                 "repro_torch.core.cluster:h100_single_config",
                 "repro_torch.core.hlo_cost:from_compiled",
                 "repro_torch.core.hlo_cost:lower_and_cost",
                 "repro_torch.core.graph_cost:lower_and_cost", "__all__"},
}


def top_level(path: Path, rewrite: bool) -> dict:
    """Each top-level statement of a module but its docstring, by name, as
    its syntax tree (no positions, so line breaks do not count); the
    reference's with its imports rewritten to the port's package."""
    src = path.read_text()
    if rewrite:
        src = src.replace("repro.core", "repro_torch.core").replace(
            "repro.configs", "repro_torch.configs")
    out = {}
    for i, node in enumerate(ast.parse(src).body):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mod = getattr(node, "module", None)
            for alias in node.names:
                key = f"{mod}:{alias.name}" if mod else alias.name
                out[key] = ast.dump(alias)
            continue
        if i == 0 and isinstance(node, ast.Expr):
            continue                                 # the module docstring
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            key = node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            key = ast.unparse(node.targets[0] if isinstance(node, ast.Assign)
                              else node.target)
        else:
            key = ast.dump(node)
        out[key] = ast.dump(node)
    return out


@pytest.mark.parametrize("module", sorted(
    p.stem for p in (ROOT / "src" / "repro" / "core").glob("*.py")))
def test_module_mirrors_the_reference(module):
    """The reference is the one source of truth: every module of the port's
    copy is the reference's with its imports rewritten, statement for
    statement, but for the differences of ``MIRROR_DIFFERS``."""
    ref_top = top_level(ROOT / "src" / "repro" / "core" / f"{module}.py",
                        rewrite=True)
    port_top = top_level(ROOT / "src" / "repro_torch" / "core"
                         / f"{module}.py", rewrite=False)
    differ = {k for k in ref_top.keys() | port_top.keys()
              if ref_top.get(k) != port_top.get(k)}
    assert differ == MIRROR_DIFFERS.get(module, set())
