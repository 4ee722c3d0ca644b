"""Runtime-plan IR (paper §2/§3.1).

A runtime plan ``P`` is a hierarchy of *program blocks* ``b ∈ B`` and
*instructions* ``inst ∈ I``.  This mirrors SystemML's runtime program:

    PROGRAM
      MAIN PROGRAM
        GENERIC (lines 1-3)      <- GenericBlock([instructions...])
        IF / FOR / WHILE / PARFOR / FUNCTION blocks, arbitrarily nested

Instruction kinds map SystemML's onto the TPU world:

  * meta      — createvar / cpvar / rmvar (symbol-table maintenance, ~free)
  * datagen   — rand / seq / iota (produces a tensor, no input IO)
  * compute   — a logical op (opcode from :mod:`repro_torch.core.linalg_ops`),
                CP (single device) or DIST (sharded across mesh axes)
  * io        — explicit state transfer: disk<->host<->hbm read/write
                (persistent reads, checkpoint writes, host staging)
  * collective— all_reduce / all_gather / reduce_scatter / all_to_all /
                permute over named mesh axes (the MR-shuffle analogue)
  * p2p       — point-to-point send/recv between neighbor positions on a
                mesh axis (pipeline stage boundaries; one link, no ring)
  * jitcall   — one compiled XLA executable; its cost comes from the
                *generated plan* (``hlo_cost``) rather than op formulas.
                This is the paper's headline object: costing what the
                compiler actually produced.

Plans are pure data — generation is cheap (paper: <0.5 ms) and costing is a
single recursive pass (:mod:`repro_torch.core.costmodel`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.symbols import MemState, TensorStat

# ---------------------------------------------------------------------------
# Instructions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Instruction:
    """Base class; concrete kinds below."""

    def describe(self) -> str:  # pragma: no cover - overridden
        return self.__class__.__name__


@dataclasses.dataclass
class CreateVar(Instruction):
    name: str
    stat: TensorStat

    def describe(self) -> str:
        return f"createvar {self.name} {list(self.stat.shape)} {self.stat.dtype} {self.stat.state.value}"


@dataclasses.dataclass
class CpVar(Instruction):
    src: str
    dst: str

    def describe(self) -> str:
        return f"cpvar {self.src} {self.dst}"


@dataclasses.dataclass
class RmVar(Instruction):
    names: Tuple[str, ...]

    def describe(self) -> str:
        return "rmvar " + " ".join(self.names)


@dataclasses.dataclass
class DataGen(Instruction):
    opcode: str              # "rand" | "seq" | "iota" | "zeros"
    output: str
    stat: TensorStat

    def describe(self) -> str:
        return f"{self.opcode} {self.output} {list(self.stat.shape)}"


@dataclasses.dataclass
class Compute(Instruction):
    """A logical operation; ``exec_type`` selects CP vs distributed.

    ``shard_axes`` names the mesh axes whose product divides the work
    (the paper's effective degree of parallelism for MR jobs).
    """

    opcode: str
    inputs: Tuple[str, ...]
    output: str
    exec_type: str = "CP"                 # "CP" | "DIST"
    shard_axes: Tuple[str, ...] = ()
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        et = self.exec_type if not self.shard_axes else f"{self.exec_type}[{','.join(self.shard_axes)}]"
        return f"{et} {self.opcode} {' '.join(self.inputs)} -> {self.output}"


@dataclasses.dataclass
class IO(Instruction):
    """State transfer for one variable (pays bandwidth of the slower leg)."""

    op: str                  # "read" | "write"
    var: str
    src: MemState = MemState.DISK
    dst: MemState = MemState.HBM
    # When writing, serialized bytes may differ from in-memory (M' vs M).
    serialized: bool = True

    def describe(self) -> str:
        return f"{self.op} {self.var} {self.src.value}->{self.dst.value}"


@dataclasses.dataclass
class Collective(Instruction):
    """all_reduce / all_gather / reduce_scatter / all_to_all / permute."""

    kind: str
    var: str
    axes: Tuple[str, ...]          # mesh axes participating
    output: Optional[str] = None   # defaults to in-place semantics
    # Optional explicit payload override (bytes per device); else derived
    # from the symbol table entry for ``var``.
    bytes_override: Optional[float] = None

    def describe(self) -> str:
        return f"{self.kind}[{','.join(self.axes)}] {self.var}"


@dataclasses.dataclass
class P2P(Instruction):
    """Point-to-point send/recv between *neighbor* positions on a mesh axis.

    The wire primitive of pipeline parallelism: a stage hands its boundary
    activations (or, on the backward path, their gradients) to the adjacent
    stage.  Unlike a :class:`Collective`, a p2p transfer rides exactly one
    link of the axis fabric — it never benefits from the wrapped-ring
    doubling of ``ClusterConfig.axis_bandwidth`` — and it moves its payload
    once (no ring phases).  Priced by :func:`repro_torch.core.linalg_ops.p2p_cost`
    at ``ClusterConfig.p2p_bw(axis)``.
    """

    var: str
    axis: str                      # mesh axis the transfer crosses
    # Optional explicit payload override (bytes per device); else derived
    # from the symbol table entry for ``var``.
    bytes_override: Optional[float] = None

    def describe(self) -> str:
        return f"p2p[{self.axis}] {self.var}"


@dataclasses.dataclass
class JitCall(Instruction):
    """One compiled executable, costed from its generated HLO.

    ``compiled_cost`` is a :class:`repro_torch.core.hlo_cost.CompiledCost` —
    FLOPs / HBM bytes / per-collective bytes extracted from the compiled
    module.  ``reads``/``writes`` hook it into live-variable state so IO
    before/after the call is accounted exactly once.
    """

    name: str
    compiled_cost: Any
    reads: Tuple[str, ...] = ()
    writes: Tuple[str, ...] = ()
    donated: Tuple[str, ...] = ()

    def describe(self) -> str:
        return f"jitcall {self.name} reads={list(self.reads)} writes={list(self.writes)}"


# ---------------------------------------------------------------------------
# Program blocks (control flow — paper Eq (1))
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GenericBlock:
    label: str
    children: List[Union[Instruction, "Block"]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ForBlock:
    label: str
    iterations: Optional[int]              # None => unknown, use N-hat
    body: List[Union[Instruction, "Block"]] = dataclasses.field(default_factory=list)
    predicate: List[Instruction] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class WhileBlock:
    label: str
    body: List[Union[Instruction, "Block"]] = dataclasses.field(default_factory=list)
    predicate: List[Instruction] = dataclasses.field(default_factory=list)
    iterations: Optional[int] = None       # almost always unknown


@dataclasses.dataclass
class ParForBlock:
    """Task-parallel loop: time scales by ceil(N / k) (paper Eq (1))."""

    label: str
    iterations: Optional[int]
    parallelism: int
    body: List[Union[Instruction, "Block"]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class IfBlock:
    label: str
    branches: List[List[Union[Instruction, "Block"]]] = dataclasses.field(default_factory=list)
    weights: Optional[Sequence[float]] = None   # None => uniform
    predicate: List[Instruction] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PipelinedLoopBlock:
    """A software-pipelined microbatch loop (GPipe-style schedule).

    ``stages`` holds S per-stage bodies; every one of the M microbatches
    flows through all S stages, but *different* microbatches occupy
    different stages concurrently, so the loop's time is not N x body:

        T = fill/drain + steady state
          = sum_s T_s           (one microbatch rippling through the pipe)
          + (M - 1) * max_s T_s (every further microbatch behind the
                                 slowest stage)

    which degenerates **bit-exactly** to the sequential :class:`ForBlock`
    semantics at S=1 (``T_first + (M-1) * T_warm``).  Work totals are NOT
    overlapped: every microbatch runs every stage, so totals aggregate as
    ``sum_s first_s + (M-1) * sum_s warm_s`` — exactly the sequential
    weights (pipelining hides time, it never removes work).

    Stage-boundary activation traffic belongs *inside* the stage bodies as
    :class:`P2P` instructions, so it pipelines (and caches) with the stage
    that pays it.
    """

    label: str
    microbatches: int              # M; the loop's trip count
    stages: List[List[Union[Instruction, "Block"]]] = dataclasses.field(
        default_factory=list)      # S per-stage bodies, pipeline order


@dataclasses.dataclass
class FunctionBlock:
    """Named function body; calls are CallInst; recursion guarded by stack."""

    name: str
    body: List[Union[Instruction, "Block"]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Call(Instruction):
    func: str

    def describe(self) -> str:
        return f"call {self.func}"


Block = Union[GenericBlock, ForBlock, WhileBlock, ParForBlock, IfBlock,
              PipelinedLoopBlock, FunctionBlock]


@dataclasses.dataclass
class Program:
    """Top-level runtime plan ``P``."""

    name: str
    blocks: List[Union[Instruction, Block]] = dataclasses.field(default_factory=list)
    functions: Dict[str, FunctionBlock] = dataclasses.field(default_factory=dict)
    # Variables that exist before the program runs (persistent inputs).
    inputs: Dict[str, TensorStat] = dataclasses.field(default_factory=dict)

    def functions_signature(self) -> Tuple:
        """Hashable identity of the function table (part of the cache key:
        two programs may bind the same function name to different bodies)."""
        return tuple(sorted((name, node_signature(fb))
                            for name, fb in self.functions.items()))

    def count_instructions(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}

        def walk(nodes):
            for n in nodes:
                if isinstance(n, Instruction):
                    k = type(n).__name__
                    counts[k] = counts.get(k, 0) + 1
                elif isinstance(n, GenericBlock):
                    walk(n.children)
                elif isinstance(n, (ForBlock, WhileBlock, ParForBlock, FunctionBlock)):
                    walk(getattr(n, "predicate", []) or [])
                    walk(n.body)
                elif isinstance(n, IfBlock):
                    walk(n.predicate)
                    for br in n.branches:
                        walk(br)
                elif isinstance(n, PipelinedLoopBlock):
                    for stage in n.stages:
                        walk(stage)

        walk(self.blocks)
        for f in self.functions.values():
            walk(f.body)
        return counts


# ---------------------------------------------------------------------------
# Hashable plan signatures (cost-memoization keys)
# ---------------------------------------------------------------------------
#
# ``node_signature`` gives every plan node a structural identity: two nodes
# with equal signatures cost identically under the same symbol-table state
# and cluster config.  Signatures are computed once per node object and
# cached on the instance — plan nodes must not be mutated after costing
# begins (they never are: generation builds a plan, costing only reads it).


def _attrs_sig(attrs: Dict[str, Any]) -> Tuple:
    return tuple(sorted(attrs.items()))


def node_signature(node) -> Tuple:
    sig = getattr(node, "_sig", None)
    if sig is None:
        sig = _compute_signature(node)
        node._sig = sig
    return sig


def _sig_list(nodes) -> Tuple:
    return tuple(node_signature(n) for n in nodes)


def _compute_signature(node) -> Tuple:
    if isinstance(node, CreateVar):
        return ("cv", node.name, node.stat.sig)
    if isinstance(node, CpVar):
        return ("cp", node.src, node.dst)
    if isinstance(node, RmVar):
        return ("rm", node.names)
    if isinstance(node, DataGen):
        return ("dg", node.opcode, node.output, node.stat.sig)
    if isinstance(node, Compute):
        return ("c", node.opcode, node.inputs, node.output, node.exec_type,
                node.shard_axes, _attrs_sig(node.attrs))
    if isinstance(node, IO):
        return ("io", node.op, node.var, node.src.value, node.dst.value,
                node.serialized)
    if isinstance(node, Collective):
        return ("co", node.kind, node.var, node.axes, node.output,
                node.bytes_override)
    if isinstance(node, P2P):
        return ("p2p", node.var, node.axis, node.bytes_override)
    if isinstance(node, JitCall):
        return ("jit", node.name, node.reads, node.writes, node.donated,
                _compiled_cost_sig(node.compiled_cost))
    if isinstance(node, Call):
        return ("call", node.func)
    if isinstance(node, GenericBlock):
        return ("g", node.label, _sig_list(node.children))
    if isinstance(node, ForBlock):
        return ("for", node.label, node.iterations,
                _sig_list(node.predicate), _sig_list(node.body))
    if isinstance(node, WhileBlock):
        return ("while", node.label, node.iterations,
                _sig_list(node.predicate), _sig_list(node.body))
    if isinstance(node, ParForBlock):
        return ("parfor", node.label, node.iterations, node.parallelism,
                _sig_list(node.body))
    if isinstance(node, IfBlock):
        return ("if", node.label,
                tuple(node.weights) if node.weights else None,
                _sig_list(node.predicate),
                tuple(_sig_list(br) for br in node.branches))
    if isinstance(node, PipelinedLoopBlock):
        return ("pipe", node.label, node.microbatches,
                tuple(_sig_list(stage) for stage in node.stages))
    if isinstance(node, FunctionBlock):
        return ("fn", node.name, _sig_list(node.body))
    raise TypeError(f"unsignable plan node {type(node)}")


def _compiled_cost_sig(cost) -> Tuple:
    """Content signature for a JitCall's CompiledCost (pure-data record)."""
    colls = tuple((c.kind, c.operand_bytes, c.result_bytes, c.group_size)
                  for c in getattr(cost, "collectives", ()))
    return (getattr(cost, "name", ""), getattr(cost, "flops_per_device", 0.0),
            getattr(cost, "bytes_per_device", 0.0),
            getattr(cost, "num_devices", 1),
            getattr(cost, "dispatch_count", 1), colls)
