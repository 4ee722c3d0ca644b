"""Multi-device dry run: trace every (arch x shape x mesh) cell's step once
on fake ``DTensor``s (counterpart of ``repro.launch.dryrun``).

For each cell this shows, without a card, that the distribution config is
coherent: the train, prefill or decode step runs on fake ``DTensor``s
(``FakeTensorMode``: shapes, no memory) placed by the plan's shardings on
the fake process group (``launch.mesh.fake_process_group``), over one H100
node's mesh ``(1, 8)`` (``single``) and two nodes' ``(2, 1, 8)``
(``multi``).  What is traced is the plain program: the kernel wrappers see
fake CPU tensors.  The cell records

  * ``memory_analysis``: the traced step's argument, output, temp and peak
    bytes on one device (``graph_cost``'s live-set count),
  * ``compiled_cost``: per-device FLOPs and bytes and the collectives
    DTensor generated,
  * ``roofline``, ``collectives_by_kind``, ``roofline_components``
    (``launch.component_cost`` on the same mesh), ``model_flops`` and
    ``useful_flops_ratio``,

into ``build/dryrun/dryrun_<arch>_<shape>_<mesh>[_<tag>].json``.  Cells
are cached: delete the file or pass ``--force`` to run one again.  A
failing cell is recorded with its traceback, and ``main`` exits 1 if any
cell failed.  Nothing is set in the environment at import.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  ... --plan '{"remat": "full", "microbatches": 4}'   (plan override)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.configs import (PORTED_ARCH_IDS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.core.cluster import (h100_multi_node_config,
                                      h100_node_config)
from repro_torch.core.planner import ShardingPlan, choose_plan
from repro_torch.launch.mesh import (abstract_mesh, fake_process_group,
                                     production_layout)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")
_AXIS_FIELDS = ("batch_axes", "tp_axes", "fsdp_axes", "ep_axes", "seq_axes",
                "pp_axes")


def cluster(mesh_kind: str):
    """The ``ClusterConfig`` of a mesh kind (``single`` / ``multi``)."""
    return h100_multi_node_config() if mesh_kind == "multi" \
        else h100_node_config()


def input_specs(arch_id: str, shape_id: str, mesh, plan: ShardingPlan
                ) -> Dict[str, Any]:
    """Fake ``DTensor`` stand-ins for every input of the cell's step, placed
    by the plan's shardings (call inside ``FakeTensorMode``).  The shapes
    come from ``model.init`` / ``init_cache`` on fake tensors."""
    import torch

    from repro_torch.launch import shardings as S
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw

    arch = get_config(arch_id)
    shape = SHAPES[shape_id]
    model = build_model(arch, "cpu")
    out: Dict[str, Any] = {}
    params = model.init(0)
    psh = S.params_shardings(mesh, plan, params)
    out["params"] = S.place_tree(params, psh)
    b, s = shape.global_batch, shape.seq_len
    if shape.mode in ("train", "prefill"):
        batch = {"tokens": torch.empty((b, s), dtype=torch.int64)}
        fshape = model.frontend_shape(b)
        if fshape is not None:
            batch["frontend"] = torch.empty(fshape, dtype=torch.float32)
        out["batch"] = S.place_tree(batch,
                                    S.batch_shardings(mesh, plan, batch))
    if shape.mode == "train":
        opt = adamw.init(adamw.AdamWConfig(), params)
        out["opt_state"] = S.place_tree(
            opt, S.opt_state_shardings(mesh, plan, psh, opt))
    else:
        cache = model.init_cache(b, s)
        out["cache"] = S.place_tree(cache,
                                    S.cache_shardings(mesh, plan, cache))
    if shape.mode == "decode":
        tok = {"t": torch.empty((b,), dtype=torch.int64)}
        out["token"] = S.place_tree(tok, S.batch_shardings(mesh, plan,
                                                           tok))["t"]
    return out


def build_step_fn(arch_id: str, shape_id: str, plan: ShardingPlan):
    """(step function, its argument names): the train step with AdamW
    (weights and moments donated, as the ``Trainer`` runs it), or the
    serve step."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, compress
    from repro_torch.runtime.train_loop import make_train_step

    model = build_model(get_config(arch_id), "cpu")
    mode = SHAPES[shape_id].mode
    if mode == "train":
        step = make_train_step(model, adamw.AdamWConfig(), plan, donate=True)

        def train_step(params, opt_state, batch):
            ef = compress.EFState(residual=None)
            p2, o2, _, metrics = step(params, opt_state, ef, batch)
            return p2, o2, metrics["loss"]
        return train_step, ("params", "opt_state", "batch")

    def serve(fn):
        def run(*args):
            with implicit_replication(), torch.no_grad():
                return fn(*args)
        return run
    if mode == "prefill":
        return serve(lambda params, batch, cache: model.prefill(
            params, batch["tokens"], cache, batch.get("frontend"))), \
            ("params", "batch", "cache")
    return serve(lambda params, token, cache: model.decode_step(
        params, token, cache)), ("params", "token", "cache")


def _artifact_path(artifact_dir: str, name: str) -> str:
    return os.path.join(artifact_dir, name.replace("/", "_") + ".json")


def run_cell(arch_id: str, shape_id: str, mesh_kind: str, *,
             plan_override: Optional[Dict] = None, tag: str = "",
             force: bool = False,
             artifact_dir: str = ARTIFACT_DIR) -> Dict[str, Any]:
    """Trace one cell (or read its cached artifact); returns its record."""
    os.makedirs(artifact_dir, exist_ok=True)
    name = f"dryrun_{arch_id}_{shape_id}_{mesh_kind}{('_' + tag) if tag else ''}"
    path = _artifact_path(artifact_dir, name)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    arch = get_config(arch_id)
    shape = SHAPES[shape_id]
    ok, why = shape_applicable(arch, shape)
    record: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_id, "mesh": mesh_kind, "tag": tag,
        "status": "skip" if not ok else "pending", "why": why,
    }
    if not ok:
        _write(path, record)
        return record

    cc = cluster(mesh_kind)
    decision = choose_plan(arch, shape, cc, top_k=1)[0]
    plan = decision.plan
    if plan_override:
        plan = dataclasses.replace(plan, **plan_override)
    record["plan"] = plan.describe()
    record["plan_fields"] = {k: list(v) if isinstance(v, tuple) else v
                             for k, v in dataclasses.asdict(plan).items()}
    record["analytical_time_s"] = decision.time
    record["analytical_hbm_gb"] = decision.hbm_est / 1e9

    t0 = time.perf_counter()
    try:
        record.update(_trace(arch_id, shape_id, mesh_kind, plan, cc, name))
    except Exception as e:  # record failures: they are bugs to fix
        record["status"] = "fail"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["wall_s"] = time.perf_counter() - t0
    _write(path, record)
    return record


def _trace(arch_id: str, shape_id: str, mesh_kind: str, plan: ShardingPlan,
           cc, name: str) -> Dict[str, Any]:
    """The traced step's cost, its components' and the derived numbers."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.graph_cost import lower_and_cost
    from repro_torch.launch import component_cost as CC_

    arch = get_config(arch_id)
    shape = SHAPES[shape_id]
    mshape, axes = production_layout(mesh_kind == "multi")
    out: Dict[str, Any] = {}
    with fake_process_group(math.prod(mshape)):
        mesh = abstract_mesh(mshape, axes)
        step_fn, arg_names = build_step_fn(arch_id, shape_id, plan)
        with FakeTensorMode():
            specs = input_specs(arch_id, shape_id, mesh, plan)
        t1 = time.perf_counter()
        _, cost = lower_and_cost(name, step_fn,
                                 [specs[n] for n in arg_names], mesh)
        out["trace_s"] = time.perf_counter() - t1
        try:
            comps = CC_.component_costs(arch, shape, plan, mesh)
            out["roofline_components"] = CC_.aggregate(comps, cc)
        except Exception as ce:
            out["roofline_components"] = {
                "error": f"{type(ce).__name__}: {ce}",
                "traceback": traceback.format_exc()[-2000:]}
    out.update({
        "status": "ok",
        "memory_analysis": {
            "argument_bytes": int(cost.argument_bytes),
            "output_bytes": int(cost.output_bytes),
            "temp_bytes": int(cost.temp_bytes),
            "peak_bytes": int(cost.peak_memory_bytes),
            "alias_bytes": 0,
        },
        "compiled_cost": cost.to_json(),
        "roofline": cost.roofline(cc),
        "collectives_by_kind": cost.collective_bytes_by_kind(),
    })
    # model flops: 6*N*D (dense) / 6*N_active*D (MoE); serve: 2*N*D
    n_active = arch.param_counts()["active"]
    toks = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                 else 1)
    out["model_flops"] = (6.0 if shape.mode == "train" else 2.0) \
        * n_active * toks
    n_dev = math.prod(mshape)
    rc = out["roofline_components"]
    if "flops_per_device" in rc:
        out["roofline_entry_only"] = out["roofline"]
        out["roofline"] = {
            k: rc[k] for k in ("compute_s", "memory_s", "collective_s",
                               "dominant", "roofline_bound_s",
                               "flops_per_device", "bytes_per_device",
                               "collective_bytes_per_device")}
        out["roofline"]["source"] = "components"
        total = rc["flops_per_device"] * n_dev
    else:
        total = cost.total_flops
    out["useful_flops_ratio"] = out["model_flops"] / total if total else None
    return out


def _write(path: str, record: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=PORTED_ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--artifact-dir", default=ARTIFACT_DIR)
    ap.add_argument("--plan", default=None,
                    help="JSON dict of ShardingPlan field overrides")
    args = ap.parse_args(argv)

    archs = PORTED_ARCH_IDS if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    override = None
    if args.plan:
        override = json.loads(args.plan)
        for k in _AXIS_FIELDS:
            if k in override:
                override[k] = tuple(override[k])

    results = []
    t0 = time.perf_counter()
    for a in archs:
        for s in shapes:
            for m in meshes:
                r = run_cell(a, s, m, plan_override=override, tag=args.tag,
                             force=args.force,
                             artifact_dir=args.artifact_dir)
                extra = ""
                if r["status"] == "ok":
                    rf = r["roofline"]
                    cerr = (r.get("roofline_components") or {}).get(
                        "error", "")
                    extra = (f" dom={rf['dominant']} "
                             f"bound={rf['roofline_bound_s'] * 1e3:.2f}ms "
                             f"src={rf.get('source', 'entry')} "
                             f"coll={json.dumps(r['collectives_by_kind'])}"
                             f"{(' CERR:' + cerr[:60]) if cerr else ''}")
                elif r["status"] == "fail":
                    extra = " " + r["error"][:120]
                    print(r.get("traceback", ""), file=sys.stderr)
                print(f"[{r['status']:4s}] {a} x {s} x {m}{extra}",
                      flush=True)
                results.append(r)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} FAILED in {time.perf_counter() - t0:.1f} s")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
