"""What the model code needs to run on ``DTensor``s (a sharded ``Trainer``,
the dry run): every helper here is the identity on a plain tensor, so the
one-device program is unchanged.

  * :func:`replicate_dims` redistributes a tensor so that none of the given
    dims is sharded and no partial sum is left, where DTensor has no
    strategy (or a faulty one) for an op on a sharded dim; the reference's
    GSPMD gathers or reduces the same there.  Each call site says which op
    needs it.
  * :func:`local_call` runs a function on the local shards of its operands
    (``local_map``), the dims it keeps sharded named: the kernel wrappers
    (a ``DTensor`` never reaches a launcher, and a wrapper keeps deciding
    by the local tensor's device alone), attention per batch and head
    (:func:`per_head`), the SSD scan, the experts, and the CE's padding.
  * :func:`shard_like` splits a tensor as another is split (the experts'
    queues as their weights).
  * :func:`split_batch` splits microbatches from each rank's own rows.
  * :func:`draw_leaf` is where ``transformer.init_params`` draws each
    random weight; under :func:`drawing` a drawer (``launch.shardings``'s
    sharded init) keeps only the rank's slice of each as it is drawn.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import torch


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


_DRAWER: Optional[Any] = None          # the drawer active under drawing()


@contextlib.contextmanager
def drawing(drawer: Any) -> Iterator[Any]:
    """Within, every :func:`draw_leaf` goes to ``drawer.leaf(shape,
    make)``."""
    global _DRAWER
    prev, _DRAWER = _DRAWER, drawer
    try:
        yield drawer
    finally:
        _DRAWER = prev


def draw_leaf(shape: Sequence[int],
              make: Callable[[Optional[Tuple[slice, ...]]], torch.Tensor]
              ) -> torch.Tensor:
    """A random weight of ``shape``: ``make(None)``, the whole leaf, with no
    drawer active.  ``make(slices)`` draws the same numbers from the
    generator and returns only ``slices`` of the leaf, so a drawer can keep
    a rank's shard without the whole leaf ever being held."""
    if _DRAWER is None:
        return make(None)
    return _DRAWER.leaf(tuple(int(n) for n in shape), make)


def keep_slice(t: torch.Tensor, slices: Optional[Tuple[slice, ...]],
               dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``; with ``slices``, a copy of that part of it only
    (never a view, which would hold the whole draw alive)."""
    if slices is None:
        return t.to(dtype)
    return t[slices].to(dtype=dtype, memory_format=torch.contiguous_format,
                        copy=True)


def replicate_dims(t: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``t`` with no mesh dim sharding any of ``dims`` (negative dims count
    from the end) and no partial sum left to reduce; a plain tensor as it
    is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    want = {d % t.ndim for d in dims}
    placements = [Replicate() if p.is_partial() or (
        p.is_shard() and p.dim % t.ndim in want) else p
        for p in t.placements]
    if list(placements) == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def shard_like(t: torch.Tensor, dim: int, like: torch.Tensor,
               like_dim: int) -> torch.Tensor:
    """``t`` with its dim ``dim`` sharded over the mesh dims that shard
    ``like``'s dim ``like_dim`` (which must not shard ``t`` elsewhere); a
    plain tensor, or ``like`` not sharded there, as it is.  From a
    replicated ``t`` this is a local slice, no communication."""
    if not (is_dtensor(t) and is_dtensor(like)):
        return t
    from torch.distributed.tensor import Shard

    placements = list(t.placements)
    for md, p in enumerate(like.placements):
        if p.is_shard() and p.dim % like.ndim == like_dim % like.ndim:
            placements[md] = Shard(dim % t.ndim)
    if placements == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def split_batch(t: torch.Tensor, parts: int) -> Tuple[torch.Tensor, ...]:
    """``t`` split into ``parts`` along dim 0.  A ``DTensor`` sharded on
    dim 0 is split on each rank's local shard (``chunk`` on the global
    tensor would gather the tokens first): microbatch ``i`` holds the
    ``i``-th part of every rank's shard, the rows of one global microbatch
    in another grouping, with the same total."""
    if not is_dtensor(t):
        return t.chunk(parts, dim=0)
    from torch.distributed.tensor import DTensor

    return tuple(DTensor.from_local(piece, t.device_mesh, t.placements,
                                    run_check=False)
                 for piece in t.to_local().chunk(parts, dim=0))


def per_head(fn: Callable, q, k, v, *rest):
    """``fn(q, k, v, *rest)``, an attention over ``[B, H, S, D]`` operands,
    on the local shards: batch and heads stay sharded where q, k and v are
    sharded alike on them, every other dim is gathered; the output is
    sharded as q is.  ``rest`` (a mask) is passed whole."""
    heads = {0: "b", 1: "h"}
    return local_call(fn, (q, k, v) + tuple(rest),
                      (heads, heads, heads) + ({},) * len(rest),
                      (("b", "h", None, None),))


def local_call(fn: Callable, args: Sequence, keep: Sequence,
               outs: Sequence):
    """``fn(*args)`` on the local shards of its tensor arguments, through
    ``local_map``.

    ``keep[i]`` maps the dims of argument ``i`` that may stay sharded to a
    label (``{0: "b", 1: "h"}``: batch and heads); every other dim of a
    ``DTensor`` argument is gathered first, since the function reduces over
    it or mixes it.  A label stays sharded only where every argument that
    has it is sharded alike on it (the local shapes must agree), and a mesh
    dim shards one label (another it would shard is gathered).  ``outs[j]``
    gives the label of each dim of output ``j`` (``None``: not sharded);
    ``fn`` returns a tuple when ``outs`` has more than one entry.  With no
    ``DTensor`` argument this is ``fn(*args)``."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a for a in args if is_dtensor(a)).device_mesh

    def mesh_dims(a, d):
        if not is_dtensor(a):
            return ()
        return tuple(md for md, p in enumerate(a.placements)
                     if p.is_shard() and p.dim == d % a.ndim)

    # the mesh dims of each label, where all its holders agree
    by_label = {}
    for a, k in zip(args, keep):
        for d, label in (k or {}).items():
            by_label.setdefault(label, set()).add(mesh_dims(a, d))
    sharding = {lb: next(iter(mds)) for lb, mds in by_label.items()
                if len(mds) == 1}
    taken = set()
    for lb in list(sharding):                     # one label a mesh dim
        if taken & set(sharding[lb]):
            del sharding[lb]
        else:
            taken |= set(sharding[lb])
    placed = []
    for a, k in zip(args, keep):
        if k and isinstance(a, torch.Tensor) and not is_dtensor(a):
            # a plain operand beside DTensors: whole on every rank
            from torch.distributed.tensor import DTensor
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if is_dtensor(a):
            k = k or {}
            a = replicate_dims(a, [d for d in range(a.ndim)
                                   if k.get(d, k.get(d - a.ndim))
                                   not in sharding])
        placed.append(a)
    out_pl = []
    for labels in outs:
        pl = [Replicate()] * mesh.ndim
        for j, lb in enumerate(labels):
            for md in sharding.get(lb, ()):
                pl[md] = Shard(j)
        out_pl.append(tuple(pl))
    in_pl = tuple(tuple(a.placements) if is_dtensor(a) else None
                  for a in placed)
    # an argument replicated over a mesh dim that shards the work (another
    # argument's label) gets a partial gradient there: each rank's local
    # backward holds its shard's share (a weight's gradient over the batch
    # shards, an activation's over the tp-sharded columns)
    working = set(taken)
    grad_pl = tuple(
        None if pl is None else [
            p if p.is_shard() else (Partial() if md in working
                                    else Replicate())
            for md, p in enumerate(pl)]
        for pl in in_pl)
    # local_map reads a tuple as one entry an output, a list as one
    # output's placements
    mapped = local_map(fn, out_placements=list(out_pl[0]) if len(outs) == 1
                       else tuple(list(p) for p in out_pl),
                       in_placements=in_pl, in_grad_placements=grad_pl,
                       device_mesh=mesh)
    return mapped(*placed)
