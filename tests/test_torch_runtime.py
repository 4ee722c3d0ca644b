"""The port's array-free runtime against the reference's on the CPU:
``runtime.train_loop.OnlineRecalibrator`` (and its ``RecalibrationEvent``),
``runtime.straggler`` and ``runtime.elastic.replan``, bit for bit, and
``elastic.reshard``.

The same inputs go through both packages in one process and every result is
compared with ``==`` (tolerance 0): these modules are plain Python over the
cost model, and the port's cost model is the reference's copy
(``tests/test_torch_core.py``).  The reference's own cases
(``tests/test_calibration.py``, ``tests/test_straggler.py``,
``tests/test_train_integration.py``, ``tests/test_resource_opt.py``,
``tests/test_torus3d.py``, ``tests/test_serving_cost.py``) are ported
alongside.  Nothing here runs a model."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core as ref
from repro.core.planner import enumerate_plans as ref_enumerate_plans
from repro.runtime import elastic as ref_elastic
from repro.runtime import straggler as ref_straggler
from repro.runtime.train_loop import OnlineRecalibrator as RefRecalibrator
import repro_torch.configs as port_configs
import repro_torch.core as port
from repro_torch.core.planner import enumerate_plans
from repro_torch.optim import adamw
from repro_torch.runtime import elastic, straggler
from repro_torch.runtime.train_loop import (OnlineRecalibrator,
                                            RecalibrationEvent)


# ---------------------------------------------------------------------------
# views: everything a result reports, comparable across the packages
# ---------------------------------------------------------------------------


def decision_view(d):
    return (d.plan.describe(), dataclasses.asdict(d.plan), d.time,
            dataclasses.asdict(d.cost.breakdown), d.hbm_est, d.feasible)


def elastic_view(ep):
    return (ep.cc.fingerprint(), ep.mesh_shape, ep.mesh_axes,
            decision_view(ep.decision), ep.lr_scale)


def event_view(e):
    return (e.step, e.ratio, e.profile.to_json(), e.profile.fingerprint(),
            e.replanned, e.old_plan, e.new_plan,
            None if e.elastic is None else elastic_view(e.elastic))


def recalibrator_view(rec):
    return (rec.plan.describe(), dataclasses.asdict(rec.plan),
            rec.estimated, rec.ewma, rec.cc.fingerprint(), rec._fixed,
            rec._totals.as_tuple())


# ---------------------------------------------------------------------------
# OnlineRecalibrator (tests/test_calibration.py's three cases)
# ---------------------------------------------------------------------------

MAMBA, TRAIN_4K = "mamba2-1.3b", "train_4k"


def flip_candidates(enumerate_fn, arch, shape, cc):
    """The reference's verified swapped pair on mamba2-1.3b x train_4k x
    single pod: under a profile fitted from plan a's drifted (x4) step
    times, a's re-costed time overtakes b's, flipping the ranking."""
    plans = {p.describe(): p for p in enumerate_fn(arch, shape, cc)}
    return (plans["dp-pure[batch=dataxmodel,remat=selective]"],
            plans["dp-pure[batch=dataxmodel,remat=full,gdtype=bfloat16]"])


def recalibrator_pair(family: int = 0):
    """(reference, port) recalibrators on mamba2-1.3b x train_4k x single
    pod, over no candidate family (``family`` 0: the full enumeration), the
    single plan a (1) or the pair a, b (2), each with its own cache."""
    out = []
    for mod, cfgs, enum, rec_cls in (
            (ref, ref_configs, ref_enumerate_plans, RefRecalibrator),
            (port, port_configs, enumerate_plans, OnlineRecalibrator)):
        arch, shape = cfgs.get_config(MAMBA), cfgs.SHAPES[TRAIN_4K]
        cc = mod.single_pod_config()
        cands = (None if family == 0
                 else list(flip_candidates(enum, arch, shape, cc))[:family])
        out.append(rec_cls(arch, shape, cc, candidates=cands,
                           cache=mod.PlanCostCache()))
    return tuple(out)


def observe_both(rec_ref, rec_port, seconds: float, step: int):
    """One observation fed to both; their events and states must agree
    field for field."""
    e_ref = rec_ref.observe(seconds, step=step)
    e_port = rec_port.observe(seconds, step=step)
    assert (e_ref is None) == (e_port is None), step
    if e_ref is not None:
        assert isinstance(e_port, RecalibrationEvent)
        assert event_view(e_port) == event_view(e_ref), step
    assert recalibrator_view(rec_port) == recalibrator_view(rec_ref), step
    return e_port


def test_recalibrators_start_equal():
    for family in (0, 1, 2):
        rec_ref, rec_port = recalibrator_pair(family)
        assert recalibrator_view(rec_port) == recalibrator_view(rec_ref)
        assert (rec_port.band, rec_port.alpha, rec_port.min_observations,
                rec_port.cooldown_steps) == ((0.85, 1.18), 0.25, 8, 16)


def test_in_band_measurements_never_trigger():
    rec_ref, rec_port = recalibrator_pair(0)
    for step in range(20):
        assert observe_both(rec_ref, rec_port, rec_ref.estimated * 1.05,
                            step) is None
    assert rec_port.events == [] and rec_port.cc.calibration is None


def test_uniform_drift_refits_without_replan():
    """A single-candidate family can never flip: drift refits the profile
    but fires no replan, the same events in both packages."""
    rec_ref, rec_port = recalibrator_pair(1)
    est0 = rec_port.estimated
    measured = est0 * 3.0
    events = [e for step in range(200)
              if (e := observe_both(rec_ref, rec_port, measured, step))]
    assert events and len(events) == len(rec_ref.events)
    for e in events:
        assert not e.replanned and e.elastic is None
        assert not e.profile.is_empty()
    assert rec_port.cc.calibration is not None
    assert abs(rec_port.estimated - measured) < abs(est0 - measured)


def test_drift_triggers_replan_exactly_when_ranking_flips():
    """Measured times at 4x the estimate flip a's and b's ranking: both
    packages fire the same event at the same step, with the same
    ``elastic.replan`` onto b under the fitted profile."""
    rec_ref, rec_port = recalibrator_pair(2)
    a, b = flip_candidates(enumerate_plans, port_configs.get_config(MAMBA),
                           port_configs.SHAPES[TRAIN_4K],
                           port.single_pod_config())
    assert rec_port.plan == a
    for step in range(12):
        assert observe_both(rec_ref, rec_port, rec_ref.estimated,
                            step) is None
    event = None
    for step in range(12, 64):
        event = observe_both(rec_ref, rec_port, rec_ref.estimated * 4.0,
                             step)
        if event is not None:
            break
    assert event is not None and event.replanned
    assert event.ratio > 1.18
    assert (event.old_plan, event.new_plan) == (a.describe(), b.describe())
    assert event.elastic.decision.plan == b
    assert event.elastic.cc.calibration is not None
    assert rec_port.plan == b
    assert rec_port.estimated == pytest.approx(
        port.choose_plan(port_configs.get_config(MAMBA),
                         port_configs.SHAPES[TRAIN_4K], rec_port.cc,
                         top_k=1, candidates=[a, b])[0].time)


def test_h100_drift_at_the_cards_ratio_refits():
    """qwen1.5-0.5b at B 8 x S 2048 on one H100 (the port's own preset,
    which the reference lacks): steps measured at 5.8 x the estimate, as
    the card reads them, trip the band at the 8th observation and refit
    once in 10 steps; the estimate moves toward the measurement."""
    from repro_torch.configs.base import ShapeConfig
    arch = port_configs.get_config("qwen1.5-0.5b")
    shape = ShapeConfig("h100_train", 2048, 8, "train")
    rec = OnlineRecalibrator(arch, shape, port.h100_single_config())
    est0 = rec.estimated
    assert rec.plan.describe() == "dp+tp[batch=data,remat=none]"
    events = [e for step in range(10)
              if (e := rec.observe(est0 * 5.8, step=step))]
    assert [e.step for e in events] == [7]
    assert events[0].ratio == pytest.approx(5.8)
    assert events[0].profile.chip_name == "h100_sxm"
    assert abs(rec.estimated - est0 * 5.8) < abs(est0 - est0 * 5.8)


# ---------------------------------------------------------------------------
# straggler (tests/test_straggler.py)
# ---------------------------------------------------------------------------


def feed(monitor, healthy, slow_entity=None, slow_factor=1.0, steps=16,
         n_entities=8):
    rng = np.random.default_rng(0)
    for _ in range(steps):
        times = {e: healthy * (1 + 0.02 * rng.standard_normal())
                 for e in range(n_entities)}
        if slow_entity is not None:
            times[slow_entity] *= slow_factor
        monitor.record(times)


def test_no_false_positive_on_healthy_cluster():
    m = straggler.StepTimeMonitor()
    feed(m, 0.5)
    assert not m.detect().is_straggler


def test_detects_single_slow_host():
    m = straggler.StepTimeMonitor()
    feed(m, 0.5, slow_entity=3, slow_factor=1.8)
    v = m.detect()
    assert v.is_straggler and v.slow_entities == [3]
    assert 1.5 < v.slowdown < 2.1


def test_warmup_period_defers_judgement():
    m = straggler.StepTimeMonitor(min_samples=8)
    feed(m, 0.5, slow_entity=1, slow_factor=3.0, steps=3)
    assert not m.detect().is_straggler


@pytest.mark.parametrize("kw", [
    dict(), dict(slow_entity=3, slow_factor=1.8),
    dict(slow_entity=1, slow_factor=3.0, steps=3),
    dict(slow_entity=5, slow_factor=1.04), dict(n_entities=1, steps=10)],
    ids=["healthy", "slow_host", "warming_up", "within_5pc", "one_entity"])
def test_verdicts_equal_the_reference(kw):
    m_ref, m_port = ref_straggler.StepTimeMonitor(), \
        straggler.StepTimeMonitor()
    feed(m_ref, 0.5, **kw)
    feed(m_port, 0.5, **kw)
    assert dataclasses.asdict(m_port.detect()) == \
        dataclasses.asdict(m_ref.detect())


def ref_h100_config():
    """The reference's ClusterConfig over the port's H100 spec (the
    reference has no H100 chip), field for field."""
    spec = ref.ChipSpec(**dataclasses.asdict(port.H100_SXM))
    cc = ref.ClusterConfig(chip=spec, mesh_shape=(1,), mesh_axes=("data",))
    assert cc.fingerprint() == port.h100_single_config().fingerprint()
    return cc


@pytest.mark.parametrize("chip", ["tpu_v5e_pod", "h100_sxm"])
@pytest.mark.parametrize("slowdown,remaining,action", [
    (2.5, 50_000, "remesh"), (1.2, 10, "tolerate")])
def test_decide_remesh_equals_the_reference(chip, slowdown, remaining,
                                            action):
    """The reference's two decisions, on a reference chip (one pod of
    v5e) and on the port's H100: the same verdict and detail."""
    if chip == "h100_sxm":
        ccs = (ref_h100_config(), port.h100_single_config())
    else:
        ccs = (ref.single_pod_config(), port.single_pod_config())
    out = []
    for mod, cc in zip((ref_straggler, straggler), ccs):
        v = mod.StragglerVerdict(True, [3], slowdown=slowdown,
                                 action="detected")
        out.append(mod.decide_remesh(
            v, cc=cc, healthy_step_time=2.0, remaining_steps=remaining,
            checkpoint_bytes_per_device=2e9, excluded_fraction=1 / 16))
    assert dataclasses.asdict(out[1]) == dataclasses.asdict(out[0])
    assert out[1].action == action and "C(tolerate)" in out[1].detail
    healthy = straggler.StragglerVerdict(False, [], 1.0, "none")
    assert straggler.decide_remesh(
        healthy, cc=ccs[1], healthy_step_time=2.0, remaining_steps=remaining,
        checkpoint_bytes_per_device=2e9, excluded_fraction=1 / 16) is healthy


# ---------------------------------------------------------------------------
# elastic.replan
# ---------------------------------------------------------------------------

QWEN = "qwen1.5-0.5b"
PROFILE = dict(chip_name="tpu_v5e", mxu={"bfloat16": {"large": 0.61}},
               hbm_fraction=0.8, ici_fraction=0.7)


def replan_both(shape_of, **kw):
    """``replan`` of qwen1.5-0.5b from one pod of v5e in both packages;
    ``shape_of(configs_module, core_module)`` gives the workload, a
    ``calibration`` is given as the profile's fields and an ``objective``
    as the name of an ``Objective`` constructor, each built in the
    package's own classes."""
    out = []
    for mod, cfgs, el in ((ref, ref_configs, ref_elastic),
                          (port, port_configs, elastic)):
        args = dict(kw)
        if "calibration" in args:
            args["calibration"] = mod.CalibrationProfile(**args[
                "calibration"])
        if "objective" in args:
            args["objective"] = getattr(mod.Objective, args["objective"])()
        out.append(el.replan(cfgs.get_config(QWEN), shape_of(cfgs, mod),
                             old_cc=mod.single_pod_config(), **args))
    assert elastic_view(out[1]) == elastic_view(out[0])
    return out[1]


@pytest.mark.parametrize("case", [
    "pinned", "chips_192", "prime_7", "serve_ttft", "calibrated_pinned",
    "calibrated_192"])
def test_replan_equals_the_reference(case):
    train = lambda cfgs, mod: cfgs.SHAPES["train_4k"]           # noqa: E731
    if case == "pinned":
        ep = replan_both(train, new_mesh_shape=(8, 16),
                         new_mesh_axes=("data", "model"))
        assert ep.lr_scale == pytest.approx(0.5)
    elif case == "chips_192":
        ep = replan_both(train, available_chips=192)
        assert ep.cc.num_chips == 192 and ep.decision.feasible
        assert 0 < ep.lr_scale <= 1.0
    elif case == "prime_7":
        ep = replan_both(lambda cfgs, mod: cfgs.SHAPES["decode_32k"],
                         available_chips=7)
        assert ep.cc.num_chips == 7 and ep.mesh_shape == (7,)
    elif case == "serve_ttft":
        ep = replan_both(lambda cfgs, mod: mod.SERVE_WORKLOADS["chat_2k"],
                         available_chips=128, objective="ttft_p99")
        assert ep.cc.num_chips == 128 and ep.decision is not None
    else:
        kw = (dict(new_mesh_shape=(8, 16), new_mesh_axes=("data", "model"))
              if case == "calibrated_pinned" else dict(available_chips=192))
        ep = replan_both(train, calibration=PROFILE, **kw)
        assert ep.cc.calibration == port.CalibrationProfile(**PROFILE)


def test_replan_needs_a_mesh_or_a_chip_count():
    for el, cfgs, mod in ((ref_elastic, ref_configs, ref),
                          (elastic, port_configs, port)):
        with pytest.raises(ValueError):
            el.replan(cfgs.get_config(QWEN), cfgs.SHAPES["train_4k"],
                      old_cc=mod.single_pod_config())


def test_replan_on_one_h100_keeps_its_mesh():
    """The recalibrator's replan on one card: the mesh it had, the same
    plan ranking as ``choose_plan`` under the carried profile, lr scale 1."""
    from repro_torch.configs.base import ShapeConfig
    arch = port_configs.get_config(QWEN)
    shape = ShapeConfig("h100_train", 2048, 8, "train")
    cc = port.h100_single_config()
    profile = port.CalibrationProfile(chip_name="h100_sxm",
                                      hbm_fraction=0.5)
    ep = elastic.replan(arch, shape, old_cc=cc, new_mesh_shape=(1,),
                        new_mesh_axes=("data",), calibration=profile)
    assert (ep.mesh_shape, ep.mesh_axes, ep.lr_scale) == ((1,), ("data",),
                                                          1.0)
    assert ep.cc.calibration == profile
    best = port.choose_plan(arch, shape, ep.cc, top_k=1)[0]
    assert decision_view(ep.decision) == decision_view(best)
    assert elastic._dp_degree(port.single_pod_config()) == 16


# ---------------------------------------------------------------------------
# elastic.reshard
# ---------------------------------------------------------------------------


def test_reshard_without_a_placement_returns_the_tree():
    tree = {"params": {"w": torch.ones(3)}, "opt": adamw.AdamWState(
        step=4, m={"w": torch.zeros(3)}, v={"w": torch.zeros(3)})}
    assert elastic.reshard(tree, None) is tree


@pytest.mark.parametrize("placement", ["meta", torch.device("meta")])
def test_reshard_moves_every_tensor_to_a_device(placement):
    """A device moves every tensor leaf (here onto the meta device, the one
    other device a CPU has); the structure, the NamedTuple, the types and
    shapes and the non-tensor leaves stay."""
    tree = {"params": {"w": torch.ones(3, 2, dtype=torch.bfloat16),
                       "blocks": [torch.zeros(4), torch.arange(5)]},
            "opt": adamw.AdamWState(step=4, m={"w": torch.zeros(3, 2)},
                                    v={"w": torch.zeros(3, 2)}),
            "pair": (torch.ones(1), 2.5)}
    moved = elastic.reshard(tree, placement)
    assert isinstance(moved["opt"], adamw.AdamWState)
    assert moved["opt"].step == 4 and moved["pair"][1] == 2.5
    assert isinstance(moved["pair"], tuple)
    leaves = [moved["params"]["w"], *moved["params"]["blocks"],
              moved["opt"].m["w"], moved["opt"].v["w"], moved["pair"][0]]
    originals = [tree["params"]["w"], *tree["params"]["blocks"],
                 tree["opt"].m["w"], tree["opt"].v["w"], tree["pair"][0]]
    for new, old in zip(leaves, originals):
        assert new.device.type == "meta"
        assert (new.dtype, new.shape) == (old.dtype, old.shape)
        assert old.device.type == "cpu"
    back = elastic.reshard({"w": torch.arange(3.0)}, "cpu")
    assert torch.equal(back["w"], torch.arange(3.0))


def test_reshard_onto_a_mesh_placement_raises():
    """Axis names without a mesh place nothing: a placement is a device, a
    ``Sharding`` or a ``(mesh, placements)`` pair
    (``tests/test_torch_sharded_train.py`` reshards onto a mesh)."""
    with pytest.raises(TypeError, match="no mesh"):
        elastic.reshard({"w": torch.ones(2)}, {"w": ("data",)})
