"""Costing the *generated* plan in PyTorch: the counterpart of the
reference's ``hlo_cost.from_compiled`` / ``lower_and_cost``.

The reference lowers and compiles a jitted function with XLA and reads its
FLOPs, bytes and memory back out of the compiled module.  PyTorch runs a
program eagerly, one aten op after another, so the plan it generates is the
sequence of ops its dispatcher sees.  :func:`lower_and_cost` traces ``fn``
once on fake copies of its arguments (``FakeTensorMode``: shapes, strides
and types, no data, no memory) under a dispatch mode that counts each op,
and returns the reference's own :class:`CompiledCost`:

  * ``flops_per_device``: ``torch.utils.flop_counter``'s formulas for the
    matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions,
    the fused attentions), plus one FLOP per output element of every other
    arithmetic op: per output element of an op tagged pointwise (a copy is
    not arithmetic), per input element of one tagged reduction, per value a
    scatter adds.  That is
    XLA's ``HloCostAnalysis`` convention for elementwise work, so the two
    packages' counts are comparable; they are not equal where the two
    decompose an op their own ways (XLA keeps transcendentals apart, and
    ``jnp.take`` selects over every gathered element), so a whole layer
    agrees within a band and a product exactly.  The untagged ops a MoE
    layer traces are counted as their XLA lowerings count them, or by the
    same rule where the lowering differs: ``sort`` as XLA's
    ``HandleSort``, ``n * ceil(log2 n)`` over the operand's ``n``
    elements (the reference's ``jax.lax.top_k``, which the port's stable
    sort stands for, lowers on the CPU to a ``TopK`` custom call that XLA
    counts as none); ``cumsum`` one add an element, the work of a scan
    (XLA's CPU lowering, a tree of ``reduce-window`` ops, counts about 17
    an element); ``_softmax`` as its decomposition (the max and the sum by
    their inputs, the subtraction, exponential and division by their
    outputs: 5 an element) and its backward 4 an element (a product, a
    sum, a difference and a product).  The comparisons and ``where`` of
    the one-hots and the capacity mask are tagged pointwise, one FLOP an
    element, as XLA counts ``compare`` and ``select``.
  * ``bytes_per_device``: for every op that is not a view or a metadata op,
    the bytes of each distinct input tensor plus the bytes of its outputs.
    Eager runs every op unfused, so this is the traffic of the plan that
    actually runs.  It is larger than the reference's bytes by design:
    XLA fuses elementwise chains into one kernel that reads its inputs and
    writes its output once (``a * 1.0001 + 1`` is two ops here, one fused
    op there).
  * ``argument_bytes`` / ``output_bytes``: the bytes of the tensors passed
    in that some op reads (jax drops an argument the program never uses)
    and of those returned.  A tensor read counts the elements it spans: a
    broadcast dimension (stride 0) is read once.
  * ``temp_bytes`` / ``peak_memory_bytes``: a live-set count of the storages
    the trace allocates (each freed when its last fake tensor dies, by
    ``weakref.finalize``): the largest live sum beyond the returned
    outputs, and the arguments plus the largest live sum.
  * ``collectives``: one :class:`CollectiveStat` for each functional
    collective the trace dispatches (``_c10d_functional.all_reduce``,
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single``; its ``wait_tensor`` skipped, as
    ``parse_collectives`` skips ``*-done``),
    with the reference's canonical kind, the bytes of its operand and result
    on one device, and the size of its group.  A collective over a group of
    one (a mesh dim of size 1) moves nothing and is left out, as XLA drops
    it.  A collective's bytes are not in ``bytes_per_device``.
  * ``unknown_dtypes``: a type missing from the byte table counts 4 bytes
    and is listed, as in ``hlo_cost._shape_bytes``, so a calibration fit
    rejects the record as polluted.

Arguments that are ``DTensor``s (on a ``DeviceMesh``: the fake process
group of ``launch.mesh.fake_process_group`` in the dry run) are traced as
fake ``DTensor``s with the same placements.  DTensor's dispatch turns each
op into ops on the local shards and the collectives its redistributions
need; the counting mode lets DTensor run first (it returns
``NotImplemented`` for an op on ``DTensor``s, as
``torch.distributed.tensor.debug.CommDebugMode`` does) and counts what it
runs, so FLOPs and bytes are per device, as XLA's ``cost_analysis``
counts the SPMD program.

Autograd's backward ops run through the same dispatch mode, so a ``fn``
that calls ``.backward()`` or ``torch.autograd.grad`` is costed with its
backward, and a checkpoint's recompute is counted where it reruns.  Eager
dispatch sees every iteration of a Python loop (a chunk loop, a layer
stack), so nothing needs unrolling for costing, unlike the reference's
``lax.scan`` bodies (``models/costing_mode.py``).

What is traced is the program the fake tensors take: on CPU tensors the
kernel wrappers take their plain versions, so the plain program, not the
kernel path, is costed and calibrated.  The reference does the same, since
HLO cannot see inside a Pallas call.

This module imports no torch at its top level (``repro_torch.core`` must
load none): :func:`lower_and_cost` imports it, as the reference's imports
jax.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Any, Callable, Dict, Sequence, Tuple

from repro_torch.core.hlo_cost import CollectiveStat, CompiledCost

# Bytes of an element by torch type name (``str(dtype)`` without "torch."),
# the counterpart of ``hlo_cost._HLO_DTYPE_BYTES``.
DTYPE_BYTES = {
    "bool": 1, "uint8": 1, "int8": 1,
    "int16": 2, "uint16": 2, "float16": 2, "bfloat16": 2,
    "int32": 4, "uint32": 4, "float32": 4,
    "int64": 8, "uint64": 8, "float64": 8, "complex64": 8,
    "complex128": 16,
    "float8_e4m3fn": 1, "float8_e4m3fnuz": 1, "float8_e5m2": 1,
    "float8_e5m2fnuz": 1, "float8_e8m0fnu": 1,
}

# Ops that allocate without writing: their outputs move no bytes.
_ALLOCATE_ONLY = frozenset(("empty", "empty_strided", "empty_like",
                            "new_empty", "new_empty_strided"))
# Ops that only move data (torch tags ``clone`` pointwise): no FLOPs, as
# XLA counts none for a copy.
_MOVE_ONLY = frozenset(("clone", "copy", "copy_", "_to_copy",
                        "lift_fresh_copy"))
# FLOPs of arithmetic ops that carry neither tag, by the elements of their
# first operand (see the module's docstring)
_UNTAGGED_FLOPS = {
    "sort": lambda n: n * math.ceil(math.log2(n)) if n > 1 else 0,
    "cumsum": lambda n: n,
    "_softmax": lambda n: 5 * n,
    "_softmax_backward_data": lambda n: 4 * n,
}


def mesh_devices(mesh) -> int:
    """Devices of ``mesh``: 1 for ``None``, ``mesh.size()`` for a
    ``DeviceMesh``, else its length (a sequence of devices, which may hold
    one device only: more need a ``DeviceMesh`` to place tensors on)."""
    if mesh is None:
        return 1
    if callable(getattr(mesh, "size", None)):
        return int(mesh.size())
    if len(mesh) != 1:
        raise TypeError(f"{len(mesh)} devices as a {type(mesh).__name__}: "
                        "costing more than one device needs a DeviceMesh "
                        "(launch.mesh) and DTensor arguments")
    return 1


# functional collectives -> the reference's canonical kinds
COLLECTIVE_KINDS = {
    "all_reduce": "all_reduce",
    "all_gather_into_tensor": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter",
    "all_to_all_single": "all_to_all",
}


def lower_and_cost(name: str, fn: Callable, args: Sequence[Any], mesh=None,
                   *, dispatch_count: int = 1) -> Tuple[Callable,
                                                        CompiledCost]:
    """Trace ``fn(*args)`` once on fake CPU copies of ``args`` and cost the
    ops it dispatches (see the module's docstring for what each field
    counts).  ``args`` is a sequence of pytrees (dicts, lists, tuples) whose
    tensor leaves may be real, on any device, or fake; each becomes a fake
    CPU tensor of its shape, strides, type and ``requires_grad``, one per
    distinct tensor.  Nothing is allocated and no kernel is launched.
    Returns ``fn`` itself, the callable to time, beside the cost.  ``mesh``
    is ``None`` (one device) or the ``DeviceMesh`` the ``DTensor`` arguments
    live on; the counts are per device either way."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils import _pytree as pytree

    n_devices = mesh_devices(mesh)
    counter = _counter_mode(torch)()
    with FakeTensorMode():
        memo: Dict[int, Any] = {}

        def to_fake(t):
            if not isinstance(t, torch.Tensor):
                return t
            if id(t) not in memo:
                memo[id(t)] = _fake_like(torch, t)
            return memo[id(t)]

        fake_args = pytree.tree_map(to_fake, list(args))
        arg_leaves = [_local(t) for t in pytree.tree_leaves(fake_args)
                      if isinstance(t, torch.Tensor)]
        counter.exclude(arg_leaves)
        with _paused_in_sharding_prop(counter), counter:
            out = fn(*fake_args)
        out_leaves = [_local(t) for t in pytree.tree_leaves(out)
                      if isinstance(t, torch.Tensor)]
        argument_bytes = sum(counter.nbytes(t) for t in arg_leaves
                             if t.untyped_storage()._cdata in counter.read)
        output_bytes = sum(counter.nbytes(t) for t in out_leaves)
    return fn, CompiledCost(
        name=name, flops_per_device=float(counter.flops),
        bytes_per_device=float(counter.bytes),
        collectives=counter.collectives,
        num_devices=n_devices, argument_bytes=float(argument_bytes),
        output_bytes=float(output_bytes),
        temp_bytes=float(max(counter.peak - output_bytes, 0)),
        peak_memory_bytes=float(argument_bytes + counter.peak),
        dispatch_count=dispatch_count,
        unknown_dtypes=sorted(counter.unknown))


@contextlib.contextmanager
def _paused_in_sharding_prop(counter):
    """Pause ``counter`` while DTensor's sharding propagation runs an op on
    global-shape fake tensors to learn its output's shape (on a cache
    miss): that op is no part of the program."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def paused(self, *args, **kwargs):
        counter.paused += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            counter.paused -= 1
    ShardingPropagator._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _local(t):
    """A ``DTensor``'s local shard; a plain tensor as it is."""
    from repro_torch.models.sharded import is_dtensor
    return t._local_tensor if is_dtensor(t) else t


def _fake_like(torch, t):
    """A fake CPU tensor of ``t``'s shape, strides, type and
    ``requires_grad``; of a ``DTensor``, a fake ``DTensor`` of its mesh and
    placements over a fake local shard."""
    local = _local(t)
    f = torch.empty_strided(local.shape, local.stride(), dtype=local.dtype,
                            device="cpu")
    if local is t:
        return f.requires_grad_(t.requires_grad)
    from torch.distributed.tensor import DTensor
    d = DTensor.from_local(f, t.device_mesh, t.placements, run_check=False,
                           shape=t.shape, stride=t.stride())
    return d.detach().requires_grad_(t.requires_grad)


def _collective(func, args, kwargs, outs, index: int):
    """The :class:`CollectiveStat` of a functional collective: its operand
    and result bytes on this device, and its group's size."""
    import torch
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.utils import _pytree as pytree

    name = func._overloadpacket.__name__
    flat = pytree.tree_leaves((args, kwargs))
    group = next(a for a in reversed(flat) if isinstance(a, str))
    ins = [t for t in flat if isinstance(t, torch.Tensor)]
    nbytes = lambda ts: float(sum(t.numel() * t.element_size() for t in ts))
    return CollectiveStat(COLLECTIVE_KINDS[name], nbytes(ins), nbytes(outs),
                          _resolve_process_group(group).size(),
                          f"{name}.{index}")


def _elementwise_flops(func, args, kwargs, ins, outs) -> int:
    """FLOPs of an op outside the matmul family: one per output element of
    a pointwise op, per input element of a reduction, per value a scatter
    adds into its target (``index_put`` with ``accumulate``, ``index_add``,
    ``scatter_add``: XLA counts a scatter's update computation); none for a
    copy or anything else."""
    import torch
    name = func._overloadpacket.__name__
    if name in _MOVE_ONLY:
        return 0
    if name in _UNTAGGED_FLOPS:
        return _UNTAGGED_FLOPS[name](args[0].numel())
    if torch.Tag.reduction in func.tags:
        return max(t.numel() for t in ins.values())
    if torch.Tag.pointwise in func.tags:
        return sum(t.numel() for t in outs)
    if name in ("index_put", "index_put_", "_index_put_impl_"):
        accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate")
        return args[2].numel() if accumulate else 0
    if name in ("index_add", "index_add_", "scatter_add", "scatter_add_"):
        return args[3].numel()
    return 0


def _counter_mode(torch):
    """The dispatch mode class that counts (built here: torch is imported
    only when a trace runs)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils import _pytree as pytree
    from torch.utils.flop_counter import flop_registry

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.unknown = set()
            self.live = 0
            self.peak = 0
            self._refs: Dict[int, int] = {}
            self._size: Dict[int, int] = {}
            self._excluded = set()
            self.read = set()               # storages some op read
            self._seen = set()              # ids of the tensors tracked
            self.collectives = []
            self.paused = 0

        def nbytes(self, t, read: bool = False) -> int:
            """Bytes of ``t``; of a tensor read, only the elements it
            spans (a broadcast dimension, stride 0, is read once)."""
            name = str(t.dtype).split(".")[-1]
            size = DTYPE_BYTES.get(name)
            if size is None:
                size = 4
                self.unknown.add(name)
            n = t.numel()
            if read and n:
                n = 1
                for dim, stride in zip(t.shape, t.stride()):
                    n *= dim if stride else 1
            return n * size

        def exclude(self, tensors) -> None:
            """Storages of the arguments: not part of the live set."""
            self._excluded.update(t.untyped_storage()._cdata
                                  for t in tensors)

        def _release(self, tid: int, key) -> None:
            self._seen.discard(tid)
            if key is None:
                return
            self._refs[key] -= 1
            if not self._refs[key]:
                del self._refs[key]
                self.live -= self._size.pop(key)

        def _track(self, t) -> None:
            """Count ``t``'s storage live until its last tensor dies."""
            if id(t) in self._seen:
                return
            self._seen.add(id(t))
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._excluded:
                key = None
            elif key not in self._refs:
                self._refs[key] = 0
                self._size[key] = storage.nbytes()
                self.live += self._size[key]
                self.peak = max(self.peak, self.live)
            if key is not None:
                self._refs[key] += 1
            weakref.finalize(t, self._release, id(t), key)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                # let DTensor run first: its ops on the local shards and
                # its collectives come back through this mode
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if self.paused:
                return out
            packet = getattr(func, "_overloadpacket", None)
            if packet is not None and func.namespace == "_c10d_functional":
                if packet.__name__ in COLLECTIVE_KINDS:
                    outs = [t for t in pytree.tree_leaves(out)
                            if isinstance(t, torch.Tensor)]
                    for t in outs:
                        self._track(t)
                    stat = _collective(func, args, kwargs, outs,
                                       len(self.collectives))
                    if stat.group_size > 1:     # a group of one moves nothing
                        self.collectives.append(stat)
                return out
            outs = [t for t in pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            for t in outs:
                self._track(t)
            if func.is_view or not outs and func.name().startswith(
                    "aten::sym_"):
                return out
            packet = func._overloadpacket
            ins = {id(t): t for t in pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)}
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            else:
                self.flops += _elementwise_flops(func, args, kwargs, ins,
                                                 outs)
            self.bytes += sum(self.nbytes(t, read=True)
                              for t in ins.values())
            self.read.update(t.untyped_storage()._cdata
                             for t in ins.values())
            if packet.__name__ not in _ALLOCATE_ONLY:
                self.bytes += sum(self.nbytes(t) for t in outs)
            return out

    return Counter
