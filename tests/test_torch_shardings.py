"""The port's sharding rules (``repro_torch.launch.shardings``) against the
reference's (``repro.launch.shardings``), and the placements they give.

Every arch of ``PORTED_ARCH_IDS`` at full size (the port's parameter tree
from ``model.init`` on fake tensors, the reference's from
``init_shapes``), for ``choose_plan``'s top three plans of ``train_4k`` on
each mesh and hand-made plans covering tp, fsdp, ep, seq and zero1, on the
reference's ``(16, 16)`` and ``(2, 16, 16)`` meshes and the port's H100
``(1, 8)`` and ``(2, 1, 8)``: every parameter's spec equals the
reference's ``PartitionSpec`` entry for entry, and so do the batch's, the
decode cache's and the ZeRO-1 moments'.  No spec lists a dim's axes out of
mesh order (the order DTensor lays several ``Shard(d)`` of one dim out in).

Then: on a fake 8-rank mesh, each rank's local shard is the slice JAX's
layout rule gives the same spec (the axes of a dim major to minor, the
rank's coordinate on each), and the reference's six ``test_shardings.py``
properties hold on the port.  The meshes are ``launch.mesh.abstract_mesh``
on the fake process group: nothing here runs on more than one device.
"""
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.core.planner import ShardingPlan as RefPlan
from repro.launch import shardings as RS
from repro.launch.mesh import abstract_mesh as ref_abstract_mesh
from repro.models.model import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.configs import PORTED_ARCH_IDS, SHAPES, get_config
from repro_torch.core.cluster import (h100_multi_node_config,
                                      h100_node_config, multi_pod_config,
                                      single_pod_config)
from repro_torch.core.planner import ShardingPlan, choose_plan
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import abstract_mesh, fake_process_group
from repro_torch.models.model import build_model
from repro_torch.optim import adamw

MESHES = {
    "pod": ((16, 16), ("data", "model"), single_pod_config),
    "2pod": ((2, 16, 16), ("pod", "data", "model"), multi_pod_config),
    "h100_node": ((1, 8), ("data", "model"), h100_node_config),
    "h100_2node": ((2, 1, 8), ("pod", "data", "model"),
                   h100_multi_node_config),
}


def hand_plans(axes):
    """tp, fsdp, ep, seq and zero1, on the mesh's axes."""
    dp = tuple(a for a in axes if a != "model")
    return [
        ShardingPlan(name="tp", batch_axes=dp, tp_axes=("model",),
                     zero1=False),
        ShardingPlan(name="tp-z1", batch_axes=dp, tp_axes=("model",),
                     zero1=True),
        ShardingPlan(name="fsdp", batch_axes=dp + ("model",),
                     fsdp_axes=dp + ("model",), zero1=False),
        ShardingPlan(name="ep-tp", batch_axes=dp, tp_axes=("model",),
                     ep_axes=("model",), zero1=True),
        ShardingPlan(name="fsdp-tp", batch_axes=dp, tp_axes=("model",),
                     fsdp_axes=dp, zero1=True),
        ShardingPlan(name="seq", batch_axes=dp, seq_axes=("model",),
                     tp_axes=("model",)),
    ]


@functools.lru_cache(maxsize=None)
def port_trees(arch_id):
    with FakeTensorMode():
        model = build_model(get_config(arch_id), "cpu")
        params = model.init(0)
        cache = model.init_cache(4, 64)
        opt = adamw.init(adamw.AdamWConfig(), params)
    return params, cache, opt


@functools.lru_cache(maxsize=None)
def ref_trees(arch_id):
    model = ref_build_model(ref_get_config(arch_id))
    shapes = model.init_shapes()
    opt = jax.eval_shape(lambda: ref_adamw.init(ref_adamw.AdamWConfig(),
                                                shapes))
    return shapes, model.cache_shapes(4, 64), opt


def ref_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(RS._pstr(p) for p in path): leaf
            for path, leaf in flat}


def port_flat(tree, prefix=""):
    out = {}
    S.map_with_paths(lambda k, v: out.__setitem__(k, v), tree)
    return out


def norm(spec, nd):
    spec = list(spec) + [None] * (nd - len(spec))
    return tuple(spec)


def to_ref(plan):
    return RefPlan(**{f: getattr(plan, f) for f in
                      plan.__dataclass_fields__})


def assert_specs_equal(port_tree, ref_tree, shapes):
    port, ref = port_flat(port_tree), ref_flat(ref_tree)
    port = {k: v for k, v in port.items() if v is not None}
    assert set(port) == set(ref) - {"pos"}, set(port) ^ set(ref)
    for key, sh in port.items():
        nd = len(shapes[key].shape)
        assert norm(sh.spec, nd) == norm(tuple(ref[key].spec), nd), key
        sh.placements                       # raises out of mesh order


def plans_for(arch_id, mesh_key):
    shape, axes, cc_fn = MESHES[mesh_key]
    top = [d.plan for d in choose_plan(get_config(arch_id),
                                       SHAPES["train_4k"], cc_fn(), top_k=3)]
    return top + hand_plans(axes)


@pytest.mark.parametrize("arch_id", PORTED_ARCH_IDS)
def test_every_spec_equals_the_reference(arch_id):
    params, cache, opt = port_trees(arch_id)
    r_params, r_cache, r_opt = ref_trees(arch_id)
    p_shapes = port_flat(params)
    c_shapes = port_flat(cache)
    batch = {"tokens": torch.empty(256, 4096, dtype=torch.int64)}
    r_batch = {"tokens": jax.ShapeDtypeStruct((256, 4096), jnp.int32)}
    checked = 0
    for mesh_key, (mshape, axes, _) in MESHES.items():
        rmesh = ref_abstract_mesh(mshape, axes)
        with fake_process_group(math.prod(mshape)):
            mesh = abstract_mesh(mshape, axes)
            for plan in plans_for(arch_id, mesh_key):
                rplan = to_ref(plan)
                psh = S.params_shardings(mesh, plan, params)
                rpsh = RS.params_shardings(rmesh, rplan, r_params)
                assert_specs_equal(psh, rpsh, p_shapes)
                osh = S.opt_state_shardings(mesh, plan, psh, opt)
                rosh = RS.opt_state_shardings(rmesh, rplan, rpsh, r_opt)
                assert_specs_equal(osh.m, rosh.m, p_shapes)
                assert_specs_equal(S.batch_shardings(mesh, plan, batch),
                                   RS.batch_shardings(rmesh, rplan, r_batch),
                                   {"tokens": batch["tokens"]})
                assert_specs_equal(S.cache_shardings(mesh, plan, cache),
                                   RS.cache_shardings(rmesh, rplan, r_cache),
                                   c_shapes)
                checked += 1
    assert checked >= 4 * 7


def jax_local_slice(shape, spec, mesh_axes, coord):
    """The slice of ``shape`` that the device at ``coord`` holds under JAX's
    layout rule: a dim split over axes (a0, a1, ...) in blocks, a0 major."""
    sizes = dict(mesh_axes)
    out = []
    for n, entry in zip(shape, norm(spec, len(shape))):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        parts, index = 1, 0
        for a in axes:
            index = index * sizes[a] + coord[a]
            parts *= sizes[a]
        step = n // parts
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "phi3.5-moe-42b-a6.6b",
                                     "mamba2-1.3b"])
def test_local_shards_follow_jax_layout(arch_id):
    """On a fake (2, 2, 2) mesh every rank's ``local_slices`` of every
    leaf equal JAX's slice for the same spec, for plans whose specs split a
    dim over two or three axes."""
    mshape, axes = (2, 2, 2), ("pod", "data", "model")
    params = port_trees(arch_id)[0]
    flat = port_flat(params)
    plans = [ShardingPlan(batch_axes=("pod", "data"),
                          fsdp_axes=("pod", "data", "model")),
             ShardingPlan(batch_axes=("pod", "data"), tp_axes=("model",),
                          fsdp_axes=("pod", "data"), ep_axes=("model",))]
    with fake_process_group(8):
        mesh = abstract_mesh(mshape, axes)
        split = 0
        for plan in plans:
            for key, sh in port_flat(
                    S.params_shardings(mesh, plan, params)).items():
                shape = flat[key].shape
                split += any(isinstance(e, tuple) for e in sh.spec)
                for rank in range(8):
                    coord = dict(zip(axes, (rank // 4, rank // 2 % 2,
                                            rank % 2)))
                    got = S.local_slices(shape, mesh, sh.placements,
                                         [coord[a] for a in axes])
                    assert got == jax_local_slice(shape, sh.spec,
                                                  zip(axes, mshape), coord)
        assert split > 0


def test_out_of_mesh_order_spec_raises():
    with fake_process_group(4):
        mesh = abstract_mesh((2, 2), ("data", "model"))
        assert len(S.Sharding(mesh, (("data", "model"),)).placements) == 2
        with pytest.raises(ValueError, match="mesh order"):
            S.Sharding(mesh, (("model", "data"),)).placements


# ---------------------------------------------------------------------------
# the reference's tests/test_shardings.py properties, on the port
# ---------------------------------------------------------------------------

PLAN_TP = ShardingPlan(batch_axes=("data",), tp_axes=("model",))
PLAN_EPTP = ShardingPlan(batch_axes=("data",), tp_axes=("model",),
                         ep_axes=("model",))


@pytest.fixture
def pod_mesh():
    """A (16, 16) fake mesh for one test: a process holds one default
    group, so none is left open across tests."""
    with fake_process_group(256):
        yield abstract_mesh((16, 16), ("data", "model"))


def test_no_axis_used_twice_in_any_spec(pod_mesh):
    for arch_id in ("deepseek-v3-671b", "phi3.5-moe-42b-a6.6b",
                    "gemma3-12b", "mamba2-1.3b", "whisper-small"):
        specs = port_flat(S.params_shardings(pod_mesh, PLAN_EPTP,
                                             port_trees(arch_id)[0]))
        for key, sh in specs.items():
            used = []
            for entry in sh.spec:
                if entry is None:
                    continue
                used += list(entry) if isinstance(entry, tuple) else [entry]
            assert len(used) == len(set(used)), (arch_id, key, sh.spec)


def test_divisibility_guard_falls_back_to_replication(pod_mesh):
    sh = S.param_sharding(pod_mesh, PLAN_TP, "blocks/attn/w_q",
                          (12, 768, 770))
    assert sh.spec[1] in ("model", None)
    sh2 = S.param_sharding(pod_mesh, PLAN_TP, "blocks/attn/w_q",
                           (12, 768, 10))
    assert sh2.spec[-1] is None


def test_moe_experts_shard_over_ep(pod_mesh):
    sh = S.param_sharding(pod_mesh, PLAN_EPTP, "blocks/moe/w_up",
                          (58, 256, 7168, 2048))
    assert sh.spec[1] == "model"
    assert sh.spec[3] is None


def test_batch_sharding_divides_batch_dim(pod_mesh):
    sh = S.batch_shardings(pod_mesh, PLAN_TP,
                           {"tokens": torch.empty(256, 4096)})
    assert sh["tokens"].spec[0] == "data"
    odd = S.batch_shardings(pod_mesh, PLAN_TP, {"tokens": torch.empty(7, 64)})
    assert odd["tokens"].spec[0] is None


def test_cache_seq_fallback_when_batch_unshardable(pod_mesh):
    with FakeTensorMode():
        shapes = {"self": {"k": torch.empty(48, 1, 8, 524288, 256,
                                            dtype=torch.bfloat16)}}
    sh = S.cache_shardings(pod_mesh, PLAN_TP, shapes)
    assert sh["self"]["k"].spec[1] is None
    assert sh["self"]["k"].spec[3] == "data"


def test_zero1_moments_pick_up_data_axis(pod_mesh):
    params, _, opt = port_trees("qwen1.5-0.5b")
    psh = S.params_shardings(pod_mesh, PLAN_TP, params)
    osh = S.opt_state_shardings(pod_mesh, PLAN_TP, psh, opt)
    m_specs, p_specs = port_flat(osh.m), port_flat(psh)
    extra = sum("data" in str(m.spec) and "data" not in str(p_specs[k].spec)
                for k, m in m_specs.items())
    assert extra > 0, "ZeRO-1 should shard some moments over data"


@pytest.mark.parametrize("mesh_key", ["2pod", "h100_2node"])
def test_no_enumerated_plan_lists_axes_out_of_mesh_order(mesh_key):
    """Every plan ``enumerate_plans`` gives on a three-axis mesh, for every
    arch and shape: every parameter's, batch's and cache's placements
    build (a dim split over several axes lists them in mesh order)."""
    from repro_torch.core.planner import enumerate_plans

    mshape, axes, cc_fn = MESHES[mesh_key]
    batch = {"tokens": torch.empty(256, 4096, dtype=torch.int64)}
    n_split = 0
    with fake_process_group(math.prod(mshape)):
        mesh = abstract_mesh(mshape, axes)
        for arch_id in PORTED_ARCH_IDS:
            params, cache, _ = port_trees(arch_id)
            plans = {p.describe(): p for s in SHAPES.values()
                     for p in enumerate_plans(get_config(arch_id), s,
                                              cc_fn())}
            for plan in plans.values():
                for tree in (S.params_shardings(mesh, plan, params),
                             S.batch_shardings(mesh, plan, batch),
                             S.cache_shardings(mesh, plan, cache)):
                    for sh in port_flat(tree).values():
                        if sh is not None:
                            sh.placements
                            n_split += any(isinstance(e, tuple)
                                           for e in sh.spec)
    assert n_split > 0
