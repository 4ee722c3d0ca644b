"""Collectives in the generated-plan cost: ``graph_cost.lower_and_cost`` on
fake ``DTensor``s and ``component_cost``'s multi-device path, against the
reference's ``component_costs`` on the same reduced arch, plan and mesh
shape ``(2, 4)`` over ``("data", "model")``.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_dryrun.py`` runs its cell); the port on the fake process group
in this process.  Reduced qwen1.5-0.5b in fp32 (2 layers), B 8 x S 64:
XLA's CPU backend widens a bf16 all-reduce to fp32 (its compiled HLO reads
``f32[...] all-reduce(%wrapped_convert)``), so bf16 activations would
count twice their bytes in the reference and not in the port.

  * ``grad_reduce``: the all-reduce bytes per device and the group size
    equal the reference's exactly with fp32 gradients (dp + tp, ZeRO-1),
    in the reference one all-reduce (XLA's combiner merges them), in the
    port one a leaf.
    With bf16 gradients (dp only) the port counts the bf16 payload and the
    reference, by the widening above, exactly twice it.
  * The other components: the kinds and bytes per device of each, against
    the reference's.  GSPMD and DTensor pick different collectives for the
    same placements; each case is stated in ``DIVERGENT`` with the factor
    its total bytes are held within (port / reference, both ways):
      - ``decoder_layer`` (train): GSPMD all-reduces 65536 bytes forward
        and twice 196608 backward (three input gradients of the
        column-parallel products in one); DTensor all-reduces the two
        row-parallel outputs (``layers.dense``), sums the partial input
        gradients before it reduces them (a reduce-scatter and two small
        all-gathers): 217088 bytes against 458752, a ratio of 0.47;
      - ``ce_head``: GSPMD all-reduces the partial logits' max and sum and
        the vocab-sharded gather (67536 bytes); DTensor all-gathers the
        logits over the vocab before the CE (64512 bytes;
        ``models.sharded.replicate_dims``: DTensor's masked gather fails to
        reduce);
      - ``embed``: GSPMD all-reduces the looked-up rows of the
        vocab-sharded table (65536 bytes); DTensor all-gathers the table's
        shard (16384 bytes here, more at a real vocab: ROADMAP Queue 3);
      - ``optimizer`` (held in its own test, exactly): both all-reduce
        the global norm's partial sums over the model axis, the reference
        in one all-reduce of 48 bytes (twelve partial sums, merged by XLA's
        combiner), the port in two of 4 bytes (each device sums its leaves
        first); DTensor also all-gathers the ZeRO-1 update back to the
        weights' placements over the data axis, which XLA leaves sharded
        inside the component: each device sends its half of every fp32
        weight, so the gathers' operand bytes are exactly half the
        ``grad_reduce`` all-reduce's (58176 of 116352 a device), a ratio
        to the reference's optimizer bytes of 1212.
    The decode layer's two all-reduces and every collective of the fp32
    dp-only plan are the reference's exactly.
  * A whole train step with two microbatches does not all-gather the
    tokens: no all-gather's operand has the bytes of a rank's token shard
    or of its microbatch.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.planner import ShardingPlan
from repro_torch.launch import component_cost as CC
from repro_torch.launch.mesh import abstract_mesh, fake_process_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = ((2, 4), ("data", "model"))
CFG = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                          dtype="float32")
PLANS = {
    "dp-tp-zero1": dict(batch_axes=("data",), tp_axes=("model",),
                        zero1=True),
    "dp-bf16": dict(batch_axes=("data",), grad_reduce_dtype="bfloat16",
                    zero1=False),
}
CELLS = [("dp-tp-zero1", "train"), ("dp-bf16", "train"),
         ("dp-tp-zero1", "decode")]
# (plan, mode, component) -> (low, high) bound on port / reference bytes
DIVERGENT = {
    ("dp-tp-zero1", "train", "decoder_layer"): (0.25, 2.0),
    ("dp-tp-zero1", "train", "ce_head"): (0.5, 2.0),
    ("dp-tp-zero1", "train", "embed"): (1 / 8, 1.0),
}
# held apart, each in a test of its own
APART = {("dp-tp-zero1", "train", "optimizer")}

REF_SCRIPT = r"""
import dataclasses, json, sys
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.core.planner import ShardingPlan
from repro.launch.mesh import make_mesh
from repro.launch import component_cost as CC
plans, cells = json.loads(sys.argv[1]), json.loads(sys.argv[2])
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for plan, mode in cells:
    p = ShardingPlan(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in plans[plan].items()})
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              dtype="float32")
    comps = CC.component_costs(cfg,
                               ShapeConfig("t", 64, 8, mode), p, mesh)
    out[plan + "|" + mode] = {c.name: [[s.kind, s.operand_bytes,
                                        s.group_size]
                                       for s in c.cost.collectives]
                              for c in comps}
print("RESULT=" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(PLANS),
         json.dumps(CELLS)], env=env, capture_output=True, text=True,
        timeout=300)
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULT=")]
    assert line, out.stdout + out.stderr
    return json.loads(line[0][len("RESULT="):])


@pytest.fixture(scope="module")
def port():
    out = {}
    with fake_process_group(math.prod(MESH[0])):
        mesh = abstract_mesh(*MESH)
        for plan, mode in CELLS:
            comps = CC.component_costs(CFG,
                                       ShapeConfig("t", 64, 8, mode),
                                       ShardingPlan(**PLANS[plan]), mesh)
            out[f"{plan}|{mode}"] = {
                c.name: [[s.kind, s.operand_bytes, s.group_size]
                         for s in c.cost.collectives] for c in comps}
    return out


def _total(stats):
    return sum(b for _, b, _ in stats)


@pytest.mark.parametrize("plan", list(PLANS))
def test_grad_reduce_equals_the_reference(plan, reference, port):
    ref = reference[f"{plan}|train"]["grad_reduce"]
    got = port[f"{plan}|train"]["grad_reduce"]
    assert {k for k, _, _ in got} == {"all_reduce"}
    widen = 2 if PLANS[plan].get("grad_reduce_dtype") == "bfloat16" else 1
    assert _total(got) * widen == _total(ref) > 0
    assert {g for _, _, g in got} == {g for _, _, g in ref} == {2}


@pytest.mark.parametrize("cell", CELLS, ids=["|".join(c) for c in CELLS])
def test_component_collectives_against_the_reference(cell, reference, port):
    key = "|".join(cell)
    ref, got = reference[key], port[key]
    assert set(got) == set(ref)
    for name in set(ref) - {"grad_reduce"}:     # held in its own test
        if cell + (name,) in APART:
            continue
        r, g = _total(ref[name]), _total(got[name])
        bound = DIVERGENT.get(cell + (name,))
        if bound is None:
            # the same collectives: kinds, bytes and group sizes
            assert sorted(map(tuple, got[name])) == \
                sorted(map(tuple, ref[name])), name
            continue
        assert r > 0 and g > 0, name
        lo, hi = bound
        assert lo <= g / r <= hi, (name, g, r)


def test_zero1_optimizer_collectives(reference, port):
    """The norm's all-reduces over the model axis, and the ZeRO-1 update
    gathered back over the data axis: half the gradient bytes a device."""
    key = "dp-tp-zero1|train"
    ref, got = reference[key]["optimizer"], port[key]["optimizer"]
    assert [k for k, _, _ in ref] == ["all_reduce"]
    data, model = MESH[0]
    assert ref[0][2] == model
    norm = [tuple(c) for c in got if c[0] == "all_reduce"]
    assert norm == [("all_reduce", 4, model)] * 2
    gathers = [c for c in got if c[0] == "all_gather"]
    assert len(gathers) + len(norm) == len(got)
    assert {g for _, _, g in gathers} == {data}
    grads = _total(reference[key]["grad_reduce"])
    assert _total(gathers) * data == grads > 0


def test_train_step_does_not_gather_the_tokens():
    from repro_torch.core.graph_cost import lower_and_cost
    from repro_torch.launch import shardings as S
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, compress
    from repro_torch.runtime.train_loop import make_train_step
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = CFG
    plan = ShardingPlan(batch_axes=("data",), tp_axes=("model",),
                        microbatches=2)
    model = build_model(cfg, "cpu")
    step = make_train_step(model, adamw.AdamWConfig(), plan, donate=True)
    b, s = 8, 64
    with fake_process_group(math.prod(MESH[0])):
        mesh = abstract_mesh(*MESH)
        with FakeTensorMode():
            params = model.init(0)
            opt = adamw.init(adamw.AdamWConfig(), params)
            psh = S.params_shardings(mesh, plan, params)
            params_d = S.place_tree(params, psh)
            opt_d = S.place_tree(opt, S.opt_state_shardings(mesh, plan, psh,
                                                            opt))
            batch = {"tokens": torch.empty(b, s, dtype=torch.int64)}
            batch_d = S.place_tree(batch, S.batch_shardings(mesh, plan,
                                                            batch))
        assert batch_d["tokens"].to_local().shape == (b // 2, s)
        _, cost = lower_and_cost(
            "train", lambda p, o, x: step(p, o, compress.EFState(None), x),
            [params_d, opt_d, batch_d], mesh)
    token_shards = {b // 2 * s * 8, b // 4 * s * 8}
    gathers = [c for c in cost.collectives
               if c.kind in ("all_gather", "all_to_all")]
    assert cost.collectives, "the step made no collective"
    assert not [c for c in gathers if c.operand_bytes in token_shards]
    assert cost.num_devices == 8
