"""The sharded ``Trainer`` (``Trainer(arch, shape, cc, mesh, ...)``) on four
CPU processes over ``gloo``, against the reference's sharded ``Trainer`` and
the port's one-process ``Trainer``.

Each case spawns four processes on a ``FileStore`` in ``tmp_path``; they
build a ``(2, 2)`` mesh over ``("data", "model")`` and run two steps of the
sharded ``Trainer`` on fp32 reduced archs at 2 layers, B 8 x S 32, with
AdamW's default eps (1e-8) at lr 3e-4 (warmup 1 step).  The reference's
sharded ``Trainer`` runs the same cases on the same ``(2, 2)`` mesh, plan,
seed and AdamW config in a subprocess on four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_dryrun.py`` runs its cell); every port run starts from the
reference's ``init_state`` weights, carried over by ``convert``, as
``tests/test_torch_trainer.py`` starts the one-process ``Trainer``:

  * qwen1.5-0.5b, batch over data, tp over model, ZeRO-1 moments, 2
    microbatches, the kernel wrappers' path (their plain versions on CPU
    tensors, reached through ``local_map``);
  * qwen1.5-0.5b, batch over data, fsdp over ``("data", "model")`` (each
    matrix's first dim split over both axes in mesh order);
  * phi3.5-moe, batch over data, experts over model (ep): the expert
    choices and drops of every moe layer equal the one-process port's;
  * mamba2-1.3b, batch over data, tp over model (the SSM heads).

Rank 0 gathers the losses, the global gradient norms, the parameters and
(moe) the routing.  Tolerance, the reference's XLA program against the
port's eager ops, both fp32, sums in other orders (found: the largest
over the four cases and the three pairs below):

  * the losses within rtol 1e-6 (found 2.4e-7), and the gradient norms,
    taken before the update, where the order of the sums is the only
    difference, within rtol 1e-6 (found 1.2e-7);
  * each leaf of the final weights within 1e-4 of the leaf's largest
    magnitude, the bound ``tests/test_torch_trainer.py`` holds the
    one-process ``Trainer`` to (found 4.2e-5).  AdamW's normalised step
    ``g / (sqrt(v) + eps)`` turns the rounding of a near-zero gradient
    element into a change of up to the learning rate, so a leaf is held to
    its scale, not element by element;
  * the attention's key bias ``b_k``, whose gradient is zero in exact
    arithmetic (a key bias shifts every score of a query row alike, which
    the softmax ignores): its weights after two steps are that rounding
    made a step of the learning rate, held within 5e-3 of its largest
    (found 1.5e-3; ``tests/test_torch_trainer.py`` holds it within 1e-3
    over 10 steps at lr 3e-3, where the weight decay and the larger steps
    shrink the share of the rounding).

Each bound holds the sharded port against the reference, the one-process
port against the reference, and the two ports against each other.

The sharded init (``shardings.init_params``) draws the one-device init's
numbers and keeps each rank's slice as it draws: on each rank of a fake
4-rank group its shards equal the one-device init's slices, and the bytes
live at once never pass the rank's state plus two fp32 matrices of the
largest drawn (the whole tree and its moments, four times that, before).

Then ``store.restore(..., shardings=...)`` on the four ranks returns each
rank's shard of a checkpoint one process wrote, and of one the reference
wrote; ``elastic.reshard`` onto the same shardings (``Sharding`` leaves, and
``(mesh, placements)`` pairs) gives the same shards; and the placed tree
saved by ``AsyncCheckpointer`` (every rank in each gather, rank 0 alone
writing) reads back whole as the tree.  These tests check placement and execution on several ranks of one
host's CPU: nothing here measures or claims multi-GPU behaviour.  Every
spawn has its own join timeout (``JOIN_TIMEOUT_S``) and fails when it runs
out, as does the reference's subprocess (``REF_TIMEOUT_S``)."""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
import weakref

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESH = ((2, 2), ("data", "model"))
JOIN_TIMEOUT_S = 120
REF_TIMEOUT_S = 240
LOSS_RTOL = 1e-6
GNORM_RTOL = 1e-6
LEAF_RTOL = 1e-4
ZERO_GRAD_LEAF_RTOL = 5e-3
ZERO_GRAD_LEAVES = ("b_k",)
STEPS = 2
OPT_KW = dict(lr=3e-4, warmup_steps=1, total_steps=20)

CASES = {
    "qwen-dp-tp-zero1": ("qwen1.5-0.5b",
                         dict(batch_axes=("data",), tp_axes=("model",),
                              zero1=True, microbatches=2), True),
    "qwen-fsdp": ("qwen1.5-0.5b",
                  dict(batch_axes=("data",), fsdp_axes=("data", "model"),
                       zero1=False), False),
    "phi-moe-ep": ("phi3.5-moe-42b-a6.6b",
                   dict(batch_axes=("data",), ep_axes=("model",),
                        zero1=False), False),
    "mamba2-tp": ("mamba2-1.3b",
                  dict(batch_axes=("data",), tp_axes=("model",),
                       zero1=False), False),
}

REF_SCRIPT = r"""
import dataclasses, json, pickle, sys
import jax
import numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.core.cluster import cpu_host_config
from repro.core.planner import ShardingPlan
from repro.launch.mesh import make_mesh
from repro.optim import adamw
from repro.runtime.train_loop import Trainer, TrainerConfig

cases, opt_kw, out_path = (json.loads(sys.argv[1]), json.loads(sys.argv[2]),
                           sys.argv[3])
mesh = make_mesh((2, 2), ("data", "model"))
cc = cpu_host_config().with_mesh((2, 2), ("data", "model"))
as_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
out = {}
for name, (arch, plan_kw) in cases.items():
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              n_layers=2)
    plan = ShardingPlan(name="case", **{
        k: tuple(v) if isinstance(v, list) else v for k, v in plan_kw.items()})
    tr = Trainer(cfg, ShapeConfig("tiny", 32, 8, "train"), cc, mesh,
                 plan=plan, opt_cfg=adamw.AdamWConfig(**opt_kw),
                 tcfg=TrainerConfig(steps=%d, log_every=1, seed=0))
    params, opt, ef = tr.init_state()
    init = as_np(params)
    res = tr.run(params=params, opt_state=opt, ef=ef)
    out[name] = {"init": init, "params": as_np(res["params"]),
                 "history": res["history"]}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
""" % STEPS


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded ``Trainer`` on every case: its initial and
    final weights (numpy) and its history."""
    out_path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cases = {k: (a, p) for k, (a, p, _) in CASES.items()}
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(cases),
         json.dumps(OPT_KW), out_path], env=env, capture_output=True,
        text=True, timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    with open(out_path, "rb") as f:
        return pickle.load(f)


def _trainer(arch_id, plan_kw, use_kernel, where):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import ShardingPlan, cpu_host_config
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config(arch_id).reduced(), dtype="float32",
                              n_layers=2)
    tcfg = TrainerConfig(steps=STEPS, log_every=1, seed=0,
                         use_kernel=use_kernel)
    return Trainer(cfg, ShapeConfig("tiny", 32, 8, "train"),
                   cpu_host_config(), where,
                   plan=ShardingPlan(name="case", **plan_kw),
                   opt_cfg=adamw.AdamWConfig(**OPT_KW), tcfg=tcfg)


def _start(trainer, init_np):
    """The reference's initial weights in the port's tree, zero moments and
    error feedback, placed by the trainer's shardings on a mesh."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.shardings import place_tree
    from repro_torch.optim import adamw, compress
    from repro_torch.optim.adamw import tree_map

    params = params_from_numpy(init_np, trainer.arch, device="cpu")
    opt = adamw.init(trainer.opt_cfg, params)
    sh = trainer.shardings(params, opt)
    if sh is not None:
        params = place_tree(params, sh["params"])
        opt = place_tree(opt, sh["opt"])
    ef = compress.EFState(residual=tree_map(
        lambda p: torch.zeros((), dtype=torch.float32), params))
    return params, opt, ef


class _Routing:
    """Records every ``moe_route``'s expert choices and keep mask."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.seen = layers, []
        self._orig = layers.moe_route

    def __enter__(self):
        def rec(*a, **kw):
            r = self._orig(*a, **kw)
            full = [_whole(t) for t in (r["gate_idx"], r["keep"])]
            self.seen.append([t.detach().clone() for t in full])
            return r
        self.layers.moe_route = rec
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self._orig


def _whole(t):
    from repro_torch.models.sharded import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _gathered(tree):
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda t: _whole(t).detach().clone(), tree)


def _run(trainer, init_np):
    from repro_torch.models.sharded import is_dtensor

    params, opt, ef = _start(trainer, init_np)
    with _Routing() as routing:
        out = trainer.run(params=params, opt_state=opt, ef=ef)
    return {"losses": [h["loss"] for h in out["history"]],
            "grad_norms": [h["grad_norm"] for h in out["history"]],
            "params": _gathered(out["params"]), "routing": routing.seen,
            "all_dtensor": all(is_dtensor(t) for t in
                               _leaves(out["params"]))}


def _leaves(tree):
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree)


def _init(rank, store_path):
    import logging
    import torch.distributed as dist
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(*MESH, device_type="cpu")


def _train_worker(rank, store_path, init_path, out_path, case):
    import torch.distributed as dist
    mesh = _init(rank, store_path)
    try:
        arch_id, plan_kw, use_kernel = CASES[case]
        with open(init_path, "rb") as f:
            init_np = pickle.load(f)
        res = _run(_trainer(arch_id, plan_kw, use_kernel, mesh), init_np)
        if rank == 0:
            torch.save(res, out_path)
    finally:
        dist.destroy_process_group()


def _spawn(fn, args):
    """Run ``fn(rank, *args)`` on WORLD processes; fail on a timeout."""
    ctx = mp.start_processes(fn, args=args, nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD} processes did not finish within "
                        f"{JOIN_TIMEOUT_S} s")


def _leaf_errors(got, want, path=""):
    """``{path: max|got - want| / max|want|}`` over the leaves (``want`` a
    tree of tensors or of numpy arrays)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return {p: e for k in want
                for p, e in _leaf_errors(got[k], want[k],
                                         f"{path}/{k}").items()}
    if isinstance(want, list):
        assert len(got) == len(want), path
        return {p: e for i, (g, w) in enumerate(zip(got, want))
                for p, e in _leaf_errors(g, w, f"{path}[{i}]").items()}
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, path
    return {path: float(np.max(np.abs(g - w))
                        / max(np.max(np.abs(w)), 1e-30))}


def _hold(got, want_losses, want_gnorms, want_params):
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norms"], want_gnorms,
                               rtol=GNORM_RTOL)
    for path, err in _leaf_errors(got["params"], want_params).items():
        bound = (ZERO_GRAD_LEAF_RTOL
                 if path.split("/")[-1] in ZERO_GRAD_LEAVES else LEAF_RTOL)
        assert err <= bound, (path, err)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_trainer_matches_one_process(case, tmp_path, reference):
    """The sharded port against the one-process port and both against the
    reference's sharded ``Trainer``, from the reference's weights."""
    ref = reference[case]
    init_path = str(tmp_path / "init.pkl")
    with open(init_path, "wb") as f:
        pickle.dump(ref["init"], f)
    out_path = str(tmp_path / "rank0.pt")
    _spawn(_train_worker, (str(tmp_path / "store"), init_path, out_path,
                           case))
    got = torch.load(out_path)
    arch_id, plan_kw, use_kernel = CASES[case]
    one = _run(_trainer(arch_id, plan_kw, use_kernel, "cpu"), ref["init"])
    assert got["all_dtensor"]
    assert len(got["losses"]) == STEPS
    ref_losses = [h["loss"] for h in ref["history"]]
    ref_gnorms = [h["grad_norm"] for h in ref["history"]]
    # the sharded port against the reference's sharded Trainer
    _hold(got, ref_losses, ref_gnorms, ref["params"])
    # the one-process port against the same, and the two ports
    _hold(one, ref_losses, ref_gnorms, ref["params"])
    _hold(got, one["losses"], one["grad_norms"], one["params"])
    assert len(got["routing"]) == len(one["routing"])
    for (gi, gk), (wi, wk) in zip(got["routing"], one["routing"]):
        assert torch.equal(gi, wi) and torch.equal(gk, wk)
    if arch_id.startswith("phi"):
        assert got["routing"], "no moe layer was routed"


# ---------------------------------------------------------------------------
# the sharded init
# ---------------------------------------------------------------------------


class _LiveBytes:
    """A dispatch mode's count of the bytes held by the storages that ops
    made under it, each storage counted once until the last tensor made on
    it dies: ``peak`` and ``largest`` (one storage)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                counter.saw(out)
                return out
        self.mode = Mode()
        self.refs, self.size = {}, {}
        self.now = self.peak = self.largest = 0

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def saw(self, out):
        from torch.utils._pytree import tree_flatten

        for t in tree_flatten(out)[0]:
            if type(t) is not torch.Tensor:
                continue
            st = t.untyped_storage()
            key, n = st.data_ptr(), st.nbytes()
            if not n:
                continue
            if key not in self.refs:
                self.refs[key], self.size[key] = 0, n
                self.now += n
                self.peak = max(self.peak, self.now)
                self.largest = max(self.largest, n)
            self.refs[key] += 1
            weakref.finalize(t, self._drop, key)

    def _drop(self, key):
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.now -= self.size.pop(key)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_init_keeps_each_rank_near_its_shards(case):
    from repro_torch.launch import shardings as S
    from repro_torch.launch.mesh import abstract_mesh, fake_process_group
    from repro_torch.optim.adamw import tree_map

    arch_id, plan_kw, use_kernel = CASES[case]
    whole = _trainer(arch_id, plan_kw, use_kernel, "cpu").model.init(0)
    matrix = 4 * max(int(np.prod(t.shape[-2:])) for t in _leaves(whole))
    for rank in range(WORLD):
        with fake_process_group(WORLD, rank=rank):
            mesh = abstract_mesh(*MESH)
            trainer = _trainer(arch_id, plan_kw, use_kernel, mesh)
            with _LiveBytes() as live:
                params, opt, _ = trainer.init_state()
            state = sum(t.to_local().untyped_storage().nbytes()
                        for t in _leaves(params) + _leaves(opt.m)
                        + _leaves(opt.v))
            assert live.peak <= state + 2 * matrix, (rank, live.peak, state)
            sh = trainer.shardings(params, opt)
            coord = mesh.get_coordinate()

            def check(t, w, s):
                assert tuple(t.placements) == tuple(s.placements)
                want = w[S.local_slices(w.shape, mesh, s.placements, coord)]
                assert torch.equal(t.to_local(), want)
            tree_map(check, params, whole, sh["params"])
            tree_map(lambda t, s: check(t, torch.zeros(t.shape), s),
                     opt.m, sh["opt"].m)


# ---------------------------------------------------------------------------
# restore onto placements
# ---------------------------------------------------------------------------

RESTORE_PLAN = dict(batch_axes=("data",), tp_axes=("model",),
                    fsdp_axes=("data",))


def _restore_worker(rank, store_path, ckpt_dirs, out_path):
    import torch.distributed as dist
    mesh = _init(rank, store_path)
    try:
        from repro_torch.checkpoint import store
        from repro_torch.core import ShardingPlan
        from repro_torch.launch import shardings as S
        from repro_torch.optim.adamw import tree_map
        from repro_torch.runtime import elastic

        report = {}
        for name, d in ckpt_dirs.items():
            whole, _ = store.restore(d, _like(d), device="cpu")
            sh = S.params_shardings(mesh, ShardingPlan(**RESTORE_PLAN),
                                    whole)
            placed, step = store.restore(d, whole, device="cpu",
                                         shardings=sh)
            # the same placement through elastic.reshard, of the whole tree
            # and (back again) of the placed one
            moved = elastic.reshard(whole, sh)
            again = elastic.reshard(placed, tree_map(
                lambda s: (mesh, s.placements), sh))
            coord = mesh.get_coordinate()

            def check(t, w, s):
                want = w[S.local_slices(w.shape, mesh, s.placements, coord)]
                return (tuple(t.placements) == tuple(s.placements)
                        and torch.equal(t.to_local(), want))
            oks = [tree_map(check, t, whole, sh)
                   for t in (placed, moved, again)]
            # the placed tree saved back: every rank joins each gather,
            # rank 0 alone writes; the file read whole is the tree
            resaved = f"{out_path}.{name}.resaved"
            ckpt = store.AsyncCheckpointer(resaved)
            ckpt.save(step + 1, placed, write=rank == 0)
            ckpt.wait()
            dist.barrier()
            back, at = store.restore(resaved, whole, device="cpu")
            oks.append(tree_map(torch.equal, back, whole))
            report[name] = (step, all(_leaves(oks)) and at == step + 1,
                            sum(any(p.is_shard() for p in s.placements)
                                for s in _leaves(sh)))
        torch.save(report, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def _like(ckpt_dir):
    """A ``tree_like`` of the checkpoint's params (CPU zeros of each
    leaf's shape), from its manifest."""
    import json
    from repro_torch.checkpoint.store import latest_step
    step = latest_step(ckpt_dir)
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "MANIFEST.json")) as f:
        leaves = json.load(f)["leaves"]
    tree = {}
    for key, ent in leaves.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.zeros(ent["shape"])
    return tree


def test_restore_onto_placements_on_four_ranks(tmp_path):
    import jax
    from repro.checkpoint import store as ref_store
    from repro.configs import get_config as ref_get_config
    from repro.models.model import build_model as ref_build
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config("qwen1.5-0.5b").reduced()           # bf16 leaves
    params = build_model(cfg, "cpu").init(3)
    store.save(str(tmp_path / "port"), 4, params)
    ref_params = ref_build(ref_get_config("qwen1.5-0.5b").reduced()).init(
        jax.random.PRNGKey(5))
    ref_store.save(str(tmp_path / "ref"), 6, ref_params)
    dirs = {"port": str(tmp_path / "port"), "ref": str(tmp_path / "ref")}
    out = str(tmp_path / "report")
    _spawn(_restore_worker, (str(tmp_path / "store"), dirs, out))
    for rank in range(WORLD):
        report = torch.load(f"{out}.{rank}")
        assert report["port"][:2] == (4, True), (rank, report)
        assert report["ref"][:2] == (6, True), (rank, report)
        assert report["port"][2] > 0 and report["ref"][2] > 0
