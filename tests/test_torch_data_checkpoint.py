"""``repro_torch.data.pipeline`` and ``repro_torch.checkpoint.store``
against the reference's on the CPU.

The pipeline: ``SyntheticLM`` and ``make_pipeline`` give the reference's
arrays for the same seed, step and host split, as numpy arrays or as
tensors on a device; the reference's ``tests/test_data.py`` cases.

The store: a checkpoint written by ``repro.checkpoint.store.save`` restores
into the port's tree bit for bit, and one written by the port restores
into the reference's; the same leaf gives byte-identical ``.npy`` files and
the same crc32s and manifest keys (bf16 stored as ``uint16`` bits, leaf
keys in ``jax.tree_util``'s order, a NamedTuple's fields as ``.name``);
``LATEST`` and garbage collection; a corrupted file and a missing leaf
raise; the async checkpointer's snapshot is taken before ``save`` returns;
the reference's ``tests/test_checkpoint.py`` cases."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs import get_config as ref_get_config
from repro.data import pipeline as ref_pipeline
from repro.models import transformer as RT
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import pipeline
from repro_torch.optim import adamw
from test_torch_moe_archs import to_numpy_tree

ARCH = "deepseek-v3-671b"


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (1, 7), (5, 123)])
@pytest.mark.parametrize("frontend", [None, (4, 8, 32)],
                         ids=["tokens", "frontend"])
def test_synthetic_lm_equals_the_reference(seed, step, frontend):
    ref = ref_pipeline.SyntheticLM(1000, 32, 4, seed=seed,
                                   frontend_shape=frontend).batch_at(step)
    mine = pipeline.SyntheticLM(1000, 32, 4, seed=seed,
                                frontend_shape=frontend).batch_at(step)
    assert sorted(mine) == sorted(ref)
    for key in ref:
        assert mine[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(mine[key], ref[key])


@pytest.mark.parametrize("device", [None, "cpu"], ids=["numpy", "tensors"])
def test_make_pipeline_equals_the_reference(device):
    """Host 1 of 2 from step 3: the reference's steps and batches, in
    order, as numpy arrays or as tensors on the device asked for."""
    kw = dict(vocab_size=500, seq_len=16, global_batch=8, host_index=1,
              num_hosts=2, seed=4, start_step=3)
    ref = ref_pipeline.make_pipeline(**kw)
    mine = pipeline.make_pipeline(**kw, device=device)
    try:
        for _ in range(4):
            (rs, rb), (ms, mb) = next(ref), next(mine)
            assert ms == rs
            tokens = mb["tokens"]
            if device is not None:
                assert isinstance(tokens, torch.Tensor)
                assert tokens.device == torch.device(device)
                assert tokens.dtype == torch.int32
                tokens = tokens.numpy()
            assert tokens.shape == (4, 16)
            np.testing.assert_array_equal(tokens, rb["tokens"])
    finally:
        ref.close()
        mine.close()


def test_batch_deterministic_per_step():
    src = pipeline.SyntheticLM(vocab_size=100, seq_len=16, batch=4, seed=1)
    a = src.batch_at(7)["tokens"]
    assert np.array_equal(a, src.batch_at(7)["tokens"])
    assert not np.array_equal(a, src.batch_at(8)["tokens"])


def test_tokens_in_range_and_learnable_structure():
    t = pipeline.SyntheticLM(vocab_size=64, seq_len=128, batch=8,
                             seed=0).batch_at(0)["tokens"]
    assert t.min() >= 0 and t.max() < 64
    deltas = (t[:, 1:] - t[:, :-1]) % 64
    _, counts = np.unique(deltas, return_counts=True)
    assert counts.max() > 3 * deltas.size / 64


def test_host_sharding_distinct_streams():
    a = pipeline.SyntheticLM(100, 16, 4, seed=0).batch_at(0)["tokens"]
    b = pipeline.SyntheticLM(100, 16, 4, seed=1).batch_at(0)["tokens"]
    assert not np.array_equal(a, b)


def test_prefetch_iterator_yields_in_order_and_closes():
    pipe = pipeline.make_pipeline(vocab_size=100, seq_len=8, global_batch=4)
    try:
        assert [next(pipe)[0] for _ in range(5)] == [0, 1, 2, 3, 4]
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pipe)


def test_frontend_shapes():
    b = pipeline.SyntheticLM(100, 16, 4, seed=0,
                             frontend_shape=(4, 8, 32)).batch_at(0)
    assert b["frontend"].shape == (4, 8, 32)
    assert b["frontend"].dtype == np.float32


def test_batches_feed_the_model():
    """A pipeline batch (int32 tokens, as the reference's) goes through
    the port's loss as it comes."""
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              dtype="float32")
    model = build_model(cfg, "cpu")
    pipe = pipeline.make_pipeline(cfg.vocab_size, 16, 2, device="cpu")
    try:
        _, batch = next(pipe)
    finally:
        pipe.close()
    loss, _ = model.loss(model.init(0), batch)
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def ref_trees():
    """The reference's deepseek ``.reduced()`` params in bf16 (the norms
    and the router fp32) and an AdamW state over them (fp32 moments, an
    int32 step), as ``{"params", "opt"}``."""
    cfg = ref_get_config(ARCH).reduced()
    params = RT.init_params(cfg, jax.random.PRNGKey(0))
    opt = ref_adamw.init(ref_adamw.AdamWConfig(), params)
    opt = opt._replace(step=jnp.asarray(3, jnp.int32),
                       m=jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5,
                                      params))
    return {"params": params, "opt": opt}


def port_trees():
    """The same values in the port's tree (the params through numpy; the
    moments and the step as the port keeps them)."""
    cfg = get_config(ARCH).reduced()
    ref = ref_trees()
    params = params_from_numpy(to_numpy_tree(ref["params"]), cfg,
                               device="cpu")
    opt = adamw.AdamWState(
        step=3,
        m=params_from_numpy(to_numpy_tree(ref["opt"].m), cfg, device="cpu",
                            dtype=torch.float32),
        v=params_from_numpy(to_numpy_tree(ref["opt"].v), cfg, device="cpu",
                            dtype=torch.float32))
    return {"params": params, "opt": opt}


def ref_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(
        jax.device_get(x).astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_leaves(tree):
    out = []
    store._map_with_paths(lambda k, leaf: out.append((k, leaf)), tree)
    return dict(out)


def test_trees_hold_bf16_and_fp32_leaves():
    params = port_trees()["params"]
    assert params["blocks"]["attn"]["w_uq"].dtype == torch.bfloat16
    assert params["blocks"]["moe"]["w_router"].dtype == torch.float32
    assert params["mtp"]["norm"].dtype == torch.float32


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """Written by ``repro.checkpoint.store.save``, restored by the port
    into its own tree: every leaf bit for bit in the saved type (bf16 from
    its bits), the step an int."""
    ref = ref_trees()
    ref_store.save(str(tmp_path), 5, ref)
    like = port_trees()
    got, step = store.restore(str(tmp_path), like)
    assert step == 5 and got["opt"].step == 3
    mine, theirs = port_leaves(got), jax.tree_util.tree_leaves(ref)
    assert len(mine) == len(theirs)
    flat_ref = dict(store._flatten_with_paths(like))
    for (key, t), r in zip(mine.items(), theirs):
        if key == ".step" or key.endswith("/.step"):
            continue
        assert t.dtype == flat_ref[key].dtype, key
        assert torch.equal(t, flat_ref[key]), key
        assert list(t.shape) == list(r.shape)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """Written by the port, restored by ``repro.checkpoint.store.restore``
    into the reference's tree: every array equal, bf16 as bf16."""
    ref = ref_trees()
    store.save(str(tmp_path), 9, port_trees())
    got, step = ref_store.restore(str(tmp_path), ref)
    assert step == 9
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                         jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype or jax.tree_util.keystr(p) == ".step"
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(p))


def test_same_leaves_give_identical_files(tmp_path):
    """The same tree saved by both packages: the same manifest keys in the
    same order, the same file per key, shapes, dtypes and crc32s, and
    byte-identical ``.npy`` files (the optimizer's step aside: the
    reference's is an int32 array, the port's a Python int)."""
    ref_dir = ref_store.save(str(tmp_path / "ref"), 1, ref_trees())
    port_dir = store.save(str(tmp_path / "port"), 1, port_trees())
    manifests = []
    for d in (ref_dir, port_dir):
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifests.append(json.load(f))
    ref_m, port_m = manifests
    assert list(port_m["leaves"]) == list(ref_m["leaves"])
    assert "opt/.m/mtp/proj" in port_m["leaves"]
    assert port_m["leaves"]["params/blocks/attn/w_uq"]["dtype"] == "bfloat16"
    compared = 0
    for key, ent in ref_m["leaves"].items():
        if key == "opt/.step":
            continue
        assert port_m["leaves"][key] == ent, key
        with open(os.path.join(ref_dir, ent["file"]), "rb") as a, \
                open(os.path.join(port_dir, ent["file"]), "rb") as b:
            assert a.read() == b.read(), key
        compared += 1
    assert compared == len(ref_m["leaves"]) - 1 > 100


@pytest.fixture
def tree():
    """The reference's test tree in the port: fp32, bf16 and an int."""
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def tree_eq(a, b):
    la, lb = store._flatten_with_paths(a), store._flatten_with_paths(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def test_save_restore_roundtrip(tmp_path, tree):
    store.save(str(tmp_path), 3, tree)
    restored, step = store.restore(str(tmp_path), tree)
    assert step == 3 and tree_eq(tree, restored)
    assert restored["nested"]["b"].dtype == torch.bfloat16


def test_latest_pointer_and_multiple_steps(tmp_path, tree):
    assert store.latest_step(str(tmp_path)) is None
    store.save(str(tmp_path), 1, tree)
    store.save(str(tmp_path), 2, tree)
    assert store.latest_step(str(tmp_path)) == 2
    with open(tmp_path / "LATEST") as f:
        assert f.read() == "step_00000002"
    _, step = store.restore(str(tmp_path), tree, step=1)
    assert step == 1
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".")]


def test_checksum_detects_corruption(tmp_path, tree):
    path = store.save(str(tmp_path), 1, tree)
    victim = next(f for f in os.listdir(path) if f.endswith(".npy"))
    with open(os.path.join(path, victim), "r+b") as f:
        f.seek(60)
        f.write(b"\xff\xff\xff")
    with pytest.raises(IOError):
        store.restore(str(tmp_path), tree)


def test_missing_leaf_rejected(tmp_path, tree):
    store.save(str(tmp_path), 1, tree)
    with pytest.raises(KeyError):
        store.restore(str(tmp_path), dict(tree, extra=torch.zeros(2)))


def test_no_checkpoint_raises(tmp_path, tree):
    with pytest.raises(FileNotFoundError):
        store.restore(str(tmp_path), tree)


def test_async_checkpointer_and_gc(tmp_path, tree):
    ck = store.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    ck.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    restored, step = store.restore(str(tmp_path), tree)
    assert step == 4 and tree_eq(tree, restored)


def test_async_snapshot_is_taken_before_save_returns(tmp_path, tree):
    """The tree is updated in place right after ``save`` returns, as a
    donated train step updates the weights: the checkpoint holds the values
    of the call."""
    before = {k: v.clone() for k, v in (("w", tree["w"]),
                                        ("b", tree["nested"]["b"]))}
    ck = store.AsyncCheckpointer(str(tmp_path))
    ck.save(1, tree)
    tree["w"].add_(100.0)
    tree["nested"]["b"].mul_(3.0)
    ck.wait()
    restored, _ = store.restore(str(tmp_path), tree)
    assert torch.equal(restored["w"], before["w"])
    assert torch.equal(restored["nested"]["b"], before["b"])


def test_async_error_surfaces_on_wait(tmp_path, tree):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = store.AsyncCheckpointer(str(blocker))
    ck.save(1, tree)
    with pytest.raises(OSError):
        ck.wait()


def test_restore_onto_a_device_and_keys_order(tmp_path):
    """``device`` places every tensor leaf; dict keys are stored sorted
    (``jax.tree_util``'s order), lists as ``[i]``, and a restored dict keeps
    the caller's key order."""
    tree = {"z": [torch.ones(2), torch.zeros(3)], "a": torch.full((2,), 2.0),
            "n": None}
    path = store.save(str(tmp_path), 1, tree)
    with open(os.path.join(path, "MANIFEST.json")) as f:
        assert list(json.load(f)["leaves"]) == ["a", "z/[0]", "z/[1]"]
    restored, _ = store.restore(str(tmp_path), tree, device="cpu")
    assert list(restored) == ["z", "a", "n"] and restored["n"] is None
    assert tree_eq(tree, restored)
