"""The port's ``Trainer`` (``repro_torch.runtime.train_loop``) on the CPU,
alone and against the reference's.

Alone: the reference's ``tests/test_train_integration.py`` and
``tests/test_system.py::test_trainer_smoke`` on the port (the loss falls,
resume is exact with the weights donated to the step and without, the
``bf16`` and ``int8_ef`` schemes learn, the ``int8_ef`` residual restarts
from zero on resume, the mamba2 smoke), and its bookkeeping (the plan from
``choose_plan``, the kernel path's default, metrics as floats, the straggler
monitor and the recalibrator fed every step).

Against the reference (three reference ``Trainer``s, built once for the
module): the port's ``Trainer.run`` from the reference's ``init_state``,
carried over by ``convert``, gives the reference's losses over 10 steps; a
checkpoint the reference's ``Trainer`` writes at step 5 resumes the port's,
and one the port's writes resumes the reference's, steps 6-9 matching the
reference's uninterrupted run.  Reduced qwen1.5-0.5b in fp32 (2 layers,
d_model 64), B 8 x S 32, as the reference's own integration test.

Tolerance: the reference's steps are one jitted XLA program, the port's
eager torch ops; both fp32, with sums in other orders.  Over 10 steps at lr
3e-3 the losses agree within rtol 1e-6 (found: at most 3.3e-7); each leaf of
the final weights and AdamW moments within 1e-4 of the leaf's largest
magnitude (found: at most 7.6e-5), but the attention's key bias ``b_k``,
whose gradient is zero in exact arithmetic (a key bias shifts every score
of a query row alike, which the softmax ignores): AdamW scales its rounding
up to a step of the learning rate, and it is held within 1e-3 of its
largest (found: 2.3e-4).  The port against itself is held exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeConfig as RefShape
from repro.core.cluster import cpu_host_config as ref_cpu_host_config
from repro.core.planner import ShardingPlan as RefPlan
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw as ref_adamw
from repro.runtime.train_loop import Trainer as RefTrainer
from repro.runtime.train_loop import TrainerConfig as RefTrainerConfig
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import ShardingPlan, cpu_host_config
from repro_torch.optim import adamw, compress
from repro_torch.runtime.train_loop import Trainer, TrainerConfig

ARCH = "qwen1.5-0.5b"
LOSS_RTOL = 1e-6
LEAF_RTOL = 1e-4
ZERO_GRAD_LEAF_RTOL = 1e-3


def _opt_kw():
    return dict(lr=3e-3, warmup_steps=2, total_steps=20)


def port_trainer(ckpt_dir=None, steps=12, arch=ARCH, plan="data",
                 shape=(32, 8), **tkw):
    """The reference test's tiny trainer, in the port, on the CPU."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tcfg = TrainerConfig(steps=steps, log_every=1, checkpoint_every=5,
                         ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
                         seed=0, **tkw)
    return Trainer(cfg, ShapeConfig("tiny", *shape, "train"),
                   cpu_host_config(), "cpu",
                   plan=ShardingPlan(batch_axes=("data",)) if plan else None,
                   opt_cfg=adamw.AdamWConfig(**_opt_kw()), tcfg=tcfg)


def ref_trainer(ckpt_dir=None, steps=10):
    cfg = dataclasses.replace(ref_get_config(ARCH).reduced(),
                              dtype="float32")
    mesh = make_host_mesh()
    cc = ref_cpu_host_config().with_mesh(tuple(mesh.devices.shape),
                                         tuple(mesh.axis_names))
    tcfg = RefTrainerConfig(steps=steps, log_every=1, checkpoint_every=5,
                            ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
                            seed=0, donate=False)
    return RefTrainer(cfg, RefShape("tiny", 32, 8, "train"), cc, mesh,
                      plan=RefPlan(batch_axes=("data",)),
                      opt_cfg=ref_adamw.AdamWConfig(**_opt_kw()), tcfg=tcfg)


def to_numpy_tree(tree):
    """A JAX pytree as nested dicts of numpy arrays, floats as float32."""
    def leaf(a):
        return (np.asarray(a, np.float32)
                if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a))
    return jax.tree.map(leaf, tree)


def port_state(ref_params_np, ref_opt_np):
    """The reference's params and AdamW state (as numpy) in the port's
    trees on the CPU."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    params = params_from_numpy(ref_params_np, cfg, device="cpu")
    opt = adamw.AdamWState(
        step=int(ref_opt_np.step),
        m=params_from_numpy(ref_opt_np.m, cfg, device="cpu",
                            dtype=torch.float32),
        v=params_from_numpy(ref_opt_np.v, cfg, device="cpu",
                            dtype=torch.float32))
    return params, opt


def losses(history, first=0):
    return [h["loss"] for h in history if h["step"] >= first]


def leaves(tree):
    out = []
    store._map_with_paths(lambda k, leaf: out.append((k, leaf)), tree)
    return dict(out)


def trees_equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return la.keys() == lb.keys() and all(
        torch.equal(x, lb[k]) if isinstance(x, torch.Tensor) else x == lb[k]
        for k, x in la.items())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Three reference ``Trainer``s: straight through 10 steps (its initial
    state kept as numpy), stopped after 6 with a checkpoint at step 5, and
    resumed to 10 from a checkpoint the port's ``Trainer`` wrote at step 5
    (started from the reference's initial state)."""
    root = tmp_path_factory.mktemp("trainer")
    straight = ref_trainer(steps=10)
    params0, opt0, _ = straight.init_state()
    init = (to_numpy_tree(params0), to_numpy_tree(opt0))
    run = straight.run()
    final = to_numpy_tree({"params": run["params"], "opt": run["opt_state"]})

    ref_dir = root / "ref"
    ref_trainer(ref_dir, steps=6).run()

    port_dir = root / "port"
    p, o = port_state(*init)
    port_trainer(port_dir, steps=6).run(params=p, opt_state=o)
    resumed = ref_trainer(port_dir, steps=10).run()
    return {"init": init, "history": run["history"], "final": final,
            "ref_dir": ref_dir, "port_dir": port_dir,
            "resumed_history": resumed["history"]}


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def test_port_trainer_matches_reference_losses(reference):
    """The port's ``Trainer.run`` from the reference's initial state:
    the reference's losses over 10 steps and its final weights and
    moments (rtols in the module's docstring)."""
    p, o = port_state(*reference["init"])
    run = port_trainer(steps=10).run(params=p, opt_state=o)
    assert [h["step"] for h in run["history"]] == list(range(10))
    np.testing.assert_allclose(losses(run["history"]),
                               losses(reference["history"]), rtol=LOSS_RTOL)
    assert run["opt_state"].step == 10
    ref_final = leaves(reference["final"])
    mine = leaves({"params": run["params"], "opt": run["opt_state"]})
    assert mine.keys() == ref_final.keys()
    for key, t in mine.items():
        if key == "opt/.step":
            continue
        want = ref_final[key]
        rtol = ZERO_GRAD_LEAF_RTOL if key == "params/blocks/attn/b_k" \
            else LEAF_RTOL
        err = np.abs(t.numpy() - want).max() / np.abs(want).max()
        assert err <= rtol, (key, err)


def test_reference_checkpoint_resumes_the_port(reference):
    """The port's ``Trainer`` finds the reference's step-5 checkpoint in
    its ``ckpt_dir``, resumes at step 6 and matches the reference's
    uninterrupted steps 6-9."""
    run = port_trainer(reference["ref_dir"], steps=10).run()
    assert [h["step"] for h in run["history"]] == [6, 7, 8, 9]
    np.testing.assert_allclose(losses(run["history"]),
                               losses(reference["history"], 6),
                               rtol=LOSS_RTOL)


def test_port_checkpoint_resumes_the_reference(reference):
    """The reference's ``Trainer`` resumes from the port's step-5
    checkpoint and matches its own uninterrupted steps 6-9."""
    hist = reference["resumed_history"]
    assert [h["step"] for h in hist] == [6, 7, 8, 9]
    np.testing.assert_allclose(losses(hist), losses(reference["history"], 6),
                               rtol=LOSS_RTOL)
    assert store.latest_step(str(reference["port_dir"])) == 5


# ---------------------------------------------------------------------------
# the port alone (tests/test_train_integration.py, test_system.py)
# ---------------------------------------------------------------------------


def test_loss_decreases_over_training():
    hist = port_trainer(steps=15).run()["history"]
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert last < first - 0.1, f"{first} -> {last}"


@pytest.mark.parametrize("donate", [False, True])
def test_checkpoint_resume_exact(tmp_path, donate):
    """10 steps straight against 6 (a checkpoint at step 5) and a resume
    to 10: the same losses, weights and moments, bit for bit, whether the
    step updates the weights in place or not."""
    straight = port_trainer(None, steps=10, donate=donate).run()
    port_trainer(tmp_path / "ck", steps=6, donate=donate).run()
    resumed = port_trainer(tmp_path / "ck", steps=10, donate=donate).run()
    assert losses(resumed["history"]) == losses(straight["history"], 6)
    assert trees_equal({"p": resumed["params"], "o": resumed["opt_state"]},
                       {"p": straight["params"], "o": straight["opt_state"]})


@pytest.mark.parametrize("scheme", ["bf16", "int8_ef"])
def test_grad_compression_schemes_still_learn(scheme):
    hist = port_trainer(steps=12, compress_scheme=scheme).run()["history"]
    assert hist[-1]["loss"] < hist[0]["loss"], scheme


def test_int8_ef_residual_restarts_on_resume(tmp_path):
    """The checkpoint holds ``{"params", "opt"}`` only, as the reference's:
    under ``int8_ef`` a resumed run is the straight run with the residual
    set to zero at step 6 (bit for bit), not the uninterrupted run, whose
    residual carries on (its weights differ)."""
    kw = dict(compress_scheme="int8_ef")
    uninterrupted = port_trainer(None, steps=10, **kw).run()
    first = port_trainer(None, steps=6, **kw).run()
    assert any(bool((r != 0).any())
               for r in leaves(first["ef"].residual).values())
    t = port_trainer(None, steps=10, **kw)
    zero_ef = compress.init_error_feedback(first["params"])
    restarted = t.run(start_step=6, params=first["params"],
                      opt_state=first["opt_state"], ef=zero_ef)
    port_trainer(tmp_path / "ck", steps=6, **kw).run()
    resumed = port_trainer(tmp_path / "ck", steps=10, **kw).run()
    assert losses(resumed["history"]) == losses(restarted["history"])
    assert trees_equal(resumed["params"], restarted["params"])
    assert not trees_equal(resumed["params"], uninterrupted["params"])


def test_trainer_smoke_mamba2():
    """The reference's system smoke: mamba2 reduced, B 4 x S 32, 3 steps,
    the plan from ``choose_plan``."""
    t = port_trainer(steps=3, arch="mamba2-1.3b", plan=None, shape=(32, 4))
    hist = t.run()["history"]
    assert len(hist) == 3
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_trainer_takes_the_plan_and_path_it_is_given():
    """``plan=None`` takes ``choose_plan``'s winner, as the reference's
    ``Trainer`` does; the kernel path is the default on CUDA only, and a
    caller may ask for it on the CPU (the wrappers then take the kernels'
    plain versions); the recalibrator and the monitor see every step, each
    metric a float."""
    from repro_torch.core import choose_plan
    t = port_trainer(steps=4, plan=None, recalibrate=True)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    best = choose_plan(cfg, ShapeConfig("tiny", 32, 8, "train"),
                       cpu_host_config(), top_k=1)[0].plan
    assert t.plan == best and t.device == torch.device("cpu")
    assert t.use_kernel is False and t.recalibrator.plan == best
    hist = t.run()["history"]
    assert len(t.monitor._hist[0]) == 4 and t.recalibrator.ewma > 0
    for h in hist:
        assert all(type(v) in (int, float) for v in h.values()), h
    assert t.monitor.detect().action == "none"
    assert port_trainer(steps=1, use_kernel=True).use_kernel is True


def test_kernel_path_on_the_cpu_matches_the_plain_path():
    """``use_kernel=True`` on CPU tensors: every wrapper takes its plain
    version, so the losses are the plain path's within fp32 rounding."""
    plain = port_trainer(steps=3).run()["history"]
    kernel = port_trainer(steps=3, use_kernel=True).run()["history"]
    np.testing.assert_allclose(losses(kernel), losses(plain), rtol=1e-5)


def test_resume_without_a_checkpoint_starts_at_zero(tmp_path):
    t = port_trainer(tmp_path / "empty", steps=2)
    params, opt, _ = t.init_state()
    assert t.maybe_resume(params, opt)[2] == 0
    assert port_trainer(None, steps=2).maybe_resume(params, opt)[2] == 0
