"""Fault-tolerant checkpointing in the reference's on-disk format (PyTorch
counterpart of ``repro.checkpoint.store``; stdlib, numpy and torch).

Layout (one directory per step), byte for byte the reference's::

    ckpt_dir/
      step_00000123/
        MANIFEST.json        # step, meta, each leaf's file, shape, dtype, crc32
        host0000_leaf0000.npy ...
      LATEST                 # "step_00000123", replaced atomically

A checkpoint written by either package restores into the other:

  * leaf keys and order are ``jax.tree_util.tree_flatten_with_path``'s:
    dict keys sorted, list and tuple items ``[i]``, a NamedTuple's fields in
    their order as ``.name`` (the reference's key string for an attribute
    key), ``None`` no leaf, the parts joined by ``/``;
  * bf16 is stored as its bits, a ``uint16`` ``.npy`` with logical dtype
    ``bfloat16`` (float8 as ``uint8``), as the reference's ``_to_savable``
    writes it; nothing here needs ``ml_dtypes``;
  * the commit is atomic: files go to ``.tmp-<step>-<host>``, the manifest
    is fsynced, the directory renamed, ``LATEST`` replaced last;
  * every file carries a crc32, checked on restore.

``AsyncCheckpointer.save`` copies every leaf to host memory before it
returns (a step that updates the weights in place may run at once) and
writes in a daemon thread.  A ``DTensor`` leaf is saved whole: its copy
gathers the shards (a collective: every rank of its mesh saves, and one,
``write=True``, writes).  ``restore`` places the leaves on ``device`` (by
default each on its ``tree_like`` leaf's device), or with ``shardings``
(a tree of ``launch.shardings.Sharding`` or of ``(mesh, placements)``)
returns ``DTensor``s: each rank reads the file and keeps its shard, as the
reference restores onto its ``NamedSharding`` tree.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models.sharded import is_dtensor

_SEP = "/"
# logical dtype -> (the numpy type of its bits, the torch type)
_CUSTOM_DTYPES = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
# the bits' type -> (a numpy type torch reads, the torch type of the bits)
_BITS = {np.uint16: (np.int16, torch.int16), np.uint8: (np.uint8, torch.uint8)}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_with_paths(fn: Callable, tree: Any, prefix: Tuple[str, ...] = ()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``, the leaves
    visited in ``jax.tree_util``'s order (see the module's docstring)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _map_with_paths(fn, tree[k], prefix + (str(k),))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}              # the caller's order
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_paths(fn, v, prefix + (f".{f}",))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, prefix + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(_SEP.join(prefix), tree)


def _flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    _map_with_paths(lambda key, leaf: out.append((key, leaf)), tree)
    return out


def _to_host(leaf: Any) -> Any:
    """A copy of ``leaf`` on the host that later in-place updates of the
    leaf cannot reach: a CPU tensor, or the leaf itself when it is not a
    tensor."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if is_dtensor(leaf):                         # gather it (its local
            leaf = leaf.full_tensor()                # one if whole)
        return leaf.clone() if leaf.device.type == "cpu" else leaf.cpu()
    return leaf


def _join_gather(leaf: Any) -> None:
    """This rank's part in gathering a ``DTensor`` leaf (a collective) for
    another rank that writes; the whole leaf is dropped at once and nothing
    comes to the host."""
    if is_dtensor(leaf):
        leaf.detach().full_tensor()


def _to_savable(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the array ``np.save`` writes, the logical dtype): a bf16 or float8
    tensor as the bits of its type, as the reference stores them."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = _to_host(leaf).contiguous()
    name = str(t.dtype).split(".")[-1]
    if name in _CUSTOM_DTYPES:
        bits, _ = _CUSTOM_DTYPES[name]
        return t.view(_BITS[bits][1]).numpy().view(bits), name
    return t.numpy(), name


def _from_savable(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    """The tensor of a loaded array (C order, as ``np.load`` gives it)."""
    if logical_dtype in _CUSTOM_DTYPES:
        bits, dtype = _CUSTOM_DTYPES[logical_dtype]
        return torch.from_numpy(arr.view(_BITS[bits][0])).view(dtype)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Any, *, host_index: int = 0,
         extra_meta: Optional[Dict] = None) -> str:
    """Synchronous save with an atomic commit; returns the step's
    directory.  Leaves may be tensors on any device, numpy arrays or
    scalars."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp-{step:08d}-{host_index}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: Dict[str, Any] = {"step": step, "leaves": {},
                                "meta": extra_meta or {}}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        savable, logical = _to_savable(leaf)
        fname = f"host{host_index:04d}_leaf{i:04d}.npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, savable, allow_pickle=False)
        with open(fpath, "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["leaves"][key] = {
            "file": fname, "shape": list(savable.shape),
            "dtype": logical, "crc32": crc,
        }
    mpath = os.path.join(tmp, "MANIFEST.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                    # atomic commit
    latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write in a daemon thread;
    keep the newest ``keep`` steps."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, *, write: bool = True,
             **kw) -> None:
        """Waits for the previous write, copies every leaf of ``tree`` to
        the host (a CUDA leaf by a blocking copy, a CPU tensor by a clone,
        a ``DTensor`` gathered whole), then returns while a thread writes
        the copy.  With ``write=False`` the rank only takes its part in
        each ``DTensor``'s gather, one leaf at a time, and keeps nothing:
        the other ranks of a sharded tree do so while one writes."""
        self.wait()
        if not write:
            _map_with_paths(lambda _, leaf: _join_gather(leaf), tree)
            return
        host_tree = _map_with_paths(lambda _, leaf: _to_host(leaf), tree)

        def _write():
            try:
                save(self.ckpt_dir, step, host_tree, **kw)
                self._gc()
            except BaseException as e:       # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            return int(f.read().strip().split("_")[-1])
    except (FileNotFoundError, ValueError):
        return None


def _is_sharding(x: Any) -> bool:
    """A ``Sharding`` (``mesh`` and ``placements``) or a ``(mesh,
    placements)`` pair."""
    if hasattr(x, "mesh") and hasattr(x, "spec"):
        return True
    return (isinstance(x, tuple) and len(x) == 2
            and hasattr(x[0], "mesh_dim_names"))


def _shardings_by_path(tree: Any, prefix: Tuple[str, ...] = ()
                       ) -> Dict[str, Any]:
    """``{path: sharding}`` over a tree of shardings, the paths as
    :func:`_map_with_paths` builds them."""
    if tree is None:
        return {}
    if _is_sharding(tree):
        return {_SEP.join(prefix): tree}
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif _is_namedtuple(tree):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return {}
    out: Dict[str, Any] = {}
    for part, v in items:
        out.update(_shardings_by_path(v, prefix + (part,)))
    return out


def _place(t: torch.Tensor, sharding: Any, device) -> torch.Tensor:
    """``t`` (whole, on the host of every rank) as a ``DTensor`` that keeps
    this rank's shard, which alone moves to ``device``."""
    from repro_torch.launch.shardings import place, place_local

    if hasattr(sharding, "spec"):
        return place(t, sharding, device)
    mesh, placements = sharding
    return place_local(t, mesh, tuple(placements), device)


def restore(ckpt_dir: str, tree_like: Any, *, step: Optional[int] = None,
            device: Optional[Union[str, torch.device]] = None,
            shardings: Any = None,
            verify: bool = True) -> Tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (the newest step unless
    ``step`` is given).  A tensor or array leaf comes back as a tensor of
    the saved type on ``device`` (default: the ``tree_like`` leaf's device,
    the CPU for a numpy leaf), a scalar leaf as a Python scalar.  With
    ``shardings`` (a tree like ``tree_like``'s whose leaves are shardings;
    see the module's docstring) each tensor leaf that has one comes back as
    a ``DTensor`` holding this rank's shard.  Raises ``KeyError`` for a
    leaf the checkpoint lacks and ``IOError`` for a file whose crc32
    differs."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    placed = _shardings_by_path(shardings)

    def load(key: str, like: Any) -> Any:
        ent = manifest["leaves"].get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        fpath = os.path.join(path, ent["file"])
        if verify:
            with open(fpath, "rb") as f:
                if zlib.crc32(f.read()) != ent["crc32"]:
                    raise IOError(f"checksum mismatch for {key} in {path}")
        arr = np.load(fpath, allow_pickle=False)
        if not isinstance(like, (torch.Tensor, np.ndarray)):
            return arr.item()
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        if key in placed:
            return _place(_from_savable(arr, ent["dtype"]), placed[key], dev)
        return _from_savable(arr, ent["dtype"]).to(dev)
    return _map_with_paths(load, tree_like), step
