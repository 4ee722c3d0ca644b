"""ShardingPlan -> shardings of the parameters, AdamW state, batch and cache
(counterpart of ``repro.launch.shardings``).

The planner's abstract decision vector becomes, for each tensor, a
:class:`Sharding`: its ``spec``, a tuple with one entry per tensor dim
(``None``, a mesh axis name, or a tuple of axis names), equal entry for
entry to the reference's ``PartitionSpec``; and its DTensor ``placements``,
one per mesh dim (``Shard(d)`` or ``Replicate()``).  DTensor's dispatch
then *generates* the collectives, and ``core.graph_cost`` costs what was
generated, as ``hlo_cost`` costs GSPMD's.

The rules are the reference's, line for line: path-based, with
divisibility guards (an axis is only given to a tensor dim it divides;
otherwise that dim stays replicated).  Paths are built as the reference's
``_pstr`` builds them: dict keys as they are, list items ``[i]``.

A tensor dim split over several axes maps to several ``Shard(d)`` in mesh
order, which DTensor lays out major to minor in mesh order; that equals
JAX's layout only when the spec lists the axes in mesh order, so
:attr:`Sharding.placements` raises otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.planner import ShardingPlan

SpecEntry = Optional[Any]           # None, an axis name, or a tuple of names


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` in mesh order."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One tensor's sharding over ``mesh``: the reference's ``PartitionSpec``
    entries (``spec``, as long as the tensor's dims or shorter, missing
    entries replicated) and the DTensor placements they give."""
    mesh: Any
    spec: Tuple[SpecEntry, ...] = ()

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        out = [Replicate() for _ in names]
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(
                    f"spec entry {entry} lists its axes out of mesh order "
                    f"{tuple(names)}: DTensor would lay the dim out in "
                    "another order than JAX")
            for md in order:
                out[md] = Shard(dim)
        return tuple(out)


def _axis_size(mesh, axes: Tuple[str, ...]) -> int:
    sizes = mesh_axes(mesh)
    n = 1
    for a in axes:
        if a in sizes:
            n *= sizes[a]
    return n


def _guard(mesh, dim: int, axes: Tuple[str, ...]):
    """axes if they divide dim, else None (replicated)."""
    if not axes:
        return None
    n = _axis_size(mesh, axes)
    if n <= 1 or dim % n != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def _ns(mesh, *spec) -> Sharding:
    return Sharding(mesh, tuple(spec))


def param_sharding(mesh, plan: ShardingPlan, path: str,
                   shape: Tuple[int, ...]) -> Sharding:
    tp, fsdp, ep = plan.tp_axes, plan.fsdp_axes, plan.ep_axes
    nd = len(shape)
    stacked = ("blocks" in path or "cycles" in path or "enc_blocks" in path
               or "dense_blocks" in path)
    off = 1 if (stacked and nd >= 2) else 0   # leading layer-stack axis

    def spec_with(dims):  # dims: {dim_index: axes tuple}; first-come wins
        out = [None] * nd
        used: set = set()
        for di, axes in dims.items():
            axes = tuple(a for a in axes if a not in used)
            g = _guard(mesh, shape[di], axes)
            if g is not None:
                out[di] = g
                used.update(axes)
        return _ns(mesh, *out)

    leaf = path.split("/")[-1]
    is_moe = "/moe/" in path or path.endswith("w_router")

    if leaf == "embed":
        return spec_with({0: tp, 1: fsdp})
    if leaf == "lm_head":
        return spec_with({nd - 1: tp, 0: fsdp})
    if leaf == "w_router":
        return spec_with({nd - 1: ()})
    if is_moe and leaf in ("w_up", "w_gate") and nd - off == 3:
        return spec_with({off: ep, nd - 1: tp, nd - 2: fsdp})   # ep wins ties
    if is_moe and leaf == "w_down" and nd - off == 3:
        return spec_with({off: ep, nd - 2: tp, nd - 1: fsdp})
    if leaf in ("w_q", "w_k", "w_v", "w_uq", "w_ukv", "w_gate", "w_up",
                "w_in", "w_dq", "w_dkv", "proj"):
        dims = {nd - 1: tp}
        if nd - off >= 2:
            dims[nd - 2] = fsdp
        return spec_with(dims)
    if leaf in ("w_o", "w_down", "w_out"):
        dims = {nd - 2: tp} if nd - off >= 2 else {}
        dims[nd - 1] = fsdp
        return spec_with(dims)
    if leaf in ("b_q", "b_k", "b_v", "conv_w", "conv_b"):
        return spec_with({nd - 1: tp})
    if leaf in ("A_log", "D", "dt_bias") and nd - off >= 1:
        return spec_with({nd - 1: tp})
    # norm scales, small vectors: replicated
    return _ns(mesh)


def map_with_paths(fn: Callable[[str, Any], Any], tree: Any,
                   prefix: str = "") -> Any:
    """``tree`` (nested dicts, lists and tuples) with each leaf replaced by
    ``fn(path, leaf)``; the path as the reference's ``_pstr`` parts joined
    by ``/`` (dict keys, ``[i]`` for a list or tuple item)."""
    def join(part):
        return f"{prefix}/{part}" if prefix else str(part)
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(map_with_paths(fn, v, join(f"[{i}]"))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _tensor_like(leaf) -> bool:
    return hasattr(leaf, "shape") and hasattr(leaf, "dtype")


def params_shardings(mesh, plan: ShardingPlan, params_shapes: Any) -> Any:
    return map_with_paths(
        lambda key, leaf: param_sharding(mesh, plan, key, tuple(leaf.shape)),
        params_shapes)


def batch_shardings(mesh, plan: ShardingPlan, batch_shapes: Any) -> Any:
    sizes = mesh_axes(mesh)
    b_axes = tuple(a for a in plan.batch_axes if a in sizes)
    s_axes = tuple(a for a in plan.seq_axes if a in sizes)

    def one(path, leaf):
        nd = len(leaf.shape)
        spec = [None] * nd
        spec[0] = _guard(mesh, leaf.shape[0], b_axes)
        if nd >= 2 and s_axes:
            spec[1] = _guard(mesh, leaf.shape[1], s_axes)
        return _ns(mesh, *spec)
    return map_with_paths(one, batch_shapes)


def cache_shardings(mesh, plan: ShardingPlan, cache_shapes: Any) -> Any:
    """Decode caches: [L, B, H, S, D]-style — batch over data, heads over
    tp.  A leaf that is not a tensor (the port's host ``pos``) gets
    ``None``."""
    sizes = mesh_axes(mesh)
    b_axes = tuple(a for a in plan.batch_axes if a in sizes)
    tp = tuple(a for a in plan.tp_axes if a in sizes)

    def one(key, leaf):
        if not _tensor_like(leaf):
            return None
        nd = len(leaf.shape)
        shape = leaf.shape
        if key.endswith("pos") or "kpos" in key:
            return _ns(mesh)
        if nd == 5:        # [L, B, H, S, D] kv / [L, B, H, P, N] ssm state
            bg = _guard(mesh, shape[1], b_axes)
            sg = None
            if bg is None and "state" not in key:
                # batch not shardable (e.g. long_500k B=1): shard KV length
                sg = _guard(mesh, shape[3], b_axes)
            return _ns(mesh, None, bg, _guard(mesh, shape[2], tp), sg, None)
        if nd == 4:        # [L, B, S, r] mla latent / [L, B, W, C] conv
            bg = _guard(mesh, shape[1], b_axes)
            sg = None
            if bg is None and "conv" not in key:
                sg = _guard(mesh, shape[2], b_axes)
            last = _guard(mesh, shape[3], tp) if "conv" in key else None
            return _ns(mesh, None, bg, sg, last)
        if nd >= 2:
            return _ns(mesh, None, _guard(mesh, shape[1], b_axes),
                       *([None] * (nd - 2)))
        return _ns(mesh)
    return map_with_paths(one, cache_shapes)


def opt_state_shardings(mesh, plan: ShardingPlan, params_sh: Any,
                        opt_shapes: Any) -> Any:
    """AdamW m/v shard like params, plus ZeRO-1: when ``plan.zero1`` the
    moments additionally shard over the data axes on the first dimension
    they divide (DTensor then reduces the gradients into the update and
    gathers the new values back to the parameters' placements: optimizer
    state never replicates over DP).  ``step`` is a host integer: its
    sharding is the replicated one, as the reference's scalar's."""
    from repro_torch.optim.adamw import AdamWState, tree_map

    if not getattr(plan, "zero1", False):
        return AdamWState(step=_ns(mesh), m=params_sh, v=params_sh)
    sizes = mesh_axes(mesh)
    b_axes = tuple(a for a in plan.batch_axes if a in sizes)

    def zero1_spec(psh: Sharding, shapes) -> Sharding:
        spec = list(psh.spec) + [None] * (len(shapes.shape) - len(psh.spec))
        used = set()
        for entry in spec:
            if entry is None:
                continue
            used.update(entry if isinstance(entry, tuple) else (entry,))
        axes = tuple(a for a in b_axes if a not in used)
        if not axes:
            return psh
        n = _axis_size(mesh, axes)
        for i, entry in enumerate(spec):
            if entry is None and shapes.shape[i] % n == 0 and n > 1:
                spec[i] = axes if len(axes) > 1 else axes[0]
                return _ns(mesh, *spec)
        return psh

    m_sh = tree_map(zero1_spec, params_sh, opt_shapes.m)
    return AdamWState(step=_ns(mesh), m=m_sh, v=m_sh)


# ---------------------------------------------------------------------------
# Placing tensors
# ---------------------------------------------------------------------------


def local_slices(shape: Sequence[int], mesh, placements,
                 coord: Sequence[int]) -> Tuple[slice, ...]:
    """The slice of a tensor of ``shape`` that the rank at mesh coordinate
    ``coord`` holds under ``placements`` (even splits: the guards make
    them so), each ``Shard(d)`` applied in mesh order."""
    bounds = [[0, int(n)] for n in shape]
    for md, p in enumerate(placements):
        if not p.is_shard():
            continue
        lo, hi = bounds[p.dim]
        step = (hi - lo) // int(mesh.shape[md])
        bounds[p.dim] = [lo + coord[md] * step, lo + (coord[md] + 1) * step]
    return tuple(slice(lo, hi) for lo, hi in bounds)


def place(full, sharding: Sharding, device=None):
    """``full`` (the same values on every rank) as a ``DTensor`` of
    ``sharding``: each rank keeps its shard, with no communication."""
    return place_local(full, sharding.mesh, sharding.placements, device)


def place_local(full, mesh, placements, device=None):
    """``full`` (the same values on every rank) as a ``DTensor`` of
    ``placements`` on ``mesh``, each rank keeping its shard, moved to
    ``device`` when one is given (the slice is cut before it moves)."""
    from repro_torch.models.sharded import is_dtensor

    if is_dtensor(full):
        return full.redistribute(mesh, placements)
    part = full[local_slices(full.shape, mesh, placements,
                             mesh.get_coordinate())]
    local = part if device is None else part.to(device)
    if local is part and part.numel() != full.numel():
        local = part.clone()             # not a view that holds the whole
    return _from_local(local.contiguous(), mesh, placements, full.shape)


def _from_local(local, mesh, placements, shape):
    from torch.distributed.tensor import DTensor

    shape = tuple(int(n) for n in shape)
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=shape, stride=tuple(reversed(stride)))


def zeros(shape, dtype, sharding: Sharding, device):
    """A ``DTensor`` of zeros of ``shape`` placed by ``sharding``: each rank
    makes its shard only."""
    import torch

    sl = local_slices(shape, sharding.mesh, sharding.placements,
                      sharding.mesh.get_coordinate())
    local = torch.zeros(tuple(len(range(*s.indices(int(n))))
                              for s, n in zip(sl, shape)),
                        dtype=dtype, device=device)
    return _from_local(local, sharding.mesh, sharding.placements, shape)


class _Recorder:
    """A drawer that draws every leaf whole (on fake tensors) and keeps
    them in the order drawn."""

    def __init__(self):
        self.drawn = []

    def leaf(self, shape, make):
        t = make(None)
        self.drawn.append(t)
        return t


class _Keeper:
    """A drawer that keeps each rank's shard of the leaves drawn, by the
    shardings given in draw order."""

    def __init__(self, order):
        self.order, self.n = order, 0

    def leaf(self, shape, make):
        sharding, want = self.order[self.n]
        self.n += 1
        if shape != want:
            raise RuntimeError(f"draw {self.n - 1}: shape {shape}, the "
                               f"recorded draw's {want}")
        sl = local_slices(shape, sharding.mesh, sharding.placements,
                          sharding.mesh.get_coordinate())
        return _from_local(make(sl), sharding.mesh, sharding.placements,
                           shape)


def init_params(model, seed, mesh, plan: ShardingPlan):
    """``model.init(seed)`` placed by the plan's shardings, each random leaf
    sharded as it is drawn: the rank draws every number (the generator
    gives the one-device init's) and keeps its slice, so its peak is its
    shards and one fp32 matrix, never the whole tree, as the reference's
    ``jit(model.init, out_shardings=...)`` makes each device's shards
    only.  The norm scales and biases (zeros and constants) are made whole
    and sliced.  Returns ``(params, params_shardings)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.sharded import drawing

    with FakeTensorMode(), drawing(_Recorder()) as rec:
        fake = model.init(seed)
    psh = params_shardings(mesh, plan, fake)
    path_of, by_path = {}, {}
    map_with_paths(lambda p, leaf: path_of.__setitem__(id(leaf), p), fake)
    map_with_paths(lambda p, sh: by_path.__setitem__(p, sh), psh)
    order = [(by_path[path_of[id(t)]], tuple(t.shape)) for t in rec.drawn]
    with drawing(_Keeper(order)) as keeper:
        params = model.init(seed)
    if keeper.n != len(order):
        raise RuntimeError(f"the init drew {keeper.n} leaves; the recorded "
                           f"one drew {len(order)}")
    return place_tree(params, psh), psh


def place_tree(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` placed by the sharding of the same path
    in ``shardings`` (:func:`place`); other leaves as they are."""
    from repro_torch.optim.adamw import AdamWState

    if isinstance(tree, AdamWState):
        return AdamWState(tree.step, place_tree(tree.m, shardings.m),
                          place_tree(tree.v, shardings.v))
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, s) for v, s in zip(tree, shardings))
    if hasattr(tree, "shape") and shardings is not None:
        return place(tree, shardings)
    return tree
