"""Live-variable tracking (paper §3.2, "Tracking Live Variable States").

A runtime plan is costed in a single pass; while walking it we maintain a
symbol table of live variables: their *size information* (shape, dtype,
sparsity — the paper's m, n, s) and their *memory state* (the paper's
HDFS-vs-in-memory distinction, generalized to the TPU storage hierarchy).

The state machine is the heart of "IO is paid exactly once": persistent
inputs start on DISK/HOST; the first instruction that consumes them pays the
transfer and flips the state to HBM; later consumers read for free (HBM
traffic is part of each op's compute-side roofline, not a separate IO term).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Optional, Tuple

from repro_torch.core.cluster import dtype_bytes
from repro_torch.core.npvec import dim_int, pmax


class MemState(enum.Enum):
    DISK = "disk"      # persistent store (checkpoint / dataset shard)  ~ HDFS
    HOST = "host"      # host DRAM (staged batch, spilled tensor)
    HBM = "hbm"        # device memory — "in-memory" in the paper's sense


@dataclasses.dataclass
class TensorStat:
    """Size information for one matrix/tensor variable.

    ``sparsity`` is the paper's s = nnz/(m*n).  Dense tensors use 1.0.  For
    MoE routed activations we reuse it as the expected expert-load fraction,
    which makes expected-size math identical to the paper's sparse-size math.

    ``shards`` is the number of devices the tensor is partitioned over —
    per-device bytes are total/shards (the paper divides by the degree of
    parallelism at instruction level; we track it on the variable so hybrid
    plans can mix replicated and sharded intermediates).
    """

    shape: Tuple[int, ...]
    dtype: str = "float32"
    sparsity: float = 1.0
    state: MemState = MemState.HBM
    shards: int = 1

    # -- size estimates (paper's M-hat and M-hat') ------------------------
    @property
    def cells(self) -> int:
        c = self.__dict__.get("_cells")
        if c is None:
            # dim_int: a dim may be a knob-grid lane vector (batched walk),
            # in which case the product is one too and the cast is skipped.
            c = dim_int(math.prod(self.shape)) if self.shape else 1
            self.__dict__["_cells"] = c
        return c

    @property
    def nnz(self) -> float:
        return self.cells * self.sparsity

    def bytes_in_memory(self) -> float:
        """M-hat: in-memory size (dense layout on device)."""
        b = self.__dict__.get("_bim")
        if b is None:
            b = self.cells * dtype_bytes(self.dtype)
            self.__dict__["_bim"] = b
        return b

    def bytes_serialized(self) -> float:
        """M-hat': serialized size (sparse-aware, e.g. checkpoint on disk)."""
        if self.sparsity >= 0.4:  # dense format cheaper beyond ~40% like SystemML
            return self.cells * dtype_bytes(self.dtype)
        # CSR-ish: value + column index per nnz + row pointers
        return self.nnz * (dtype_bytes(self.dtype) + 4) + 4 * (self.shape[0] if self.shape else 1)

    def bytes_per_device(self) -> float:
        b = self.__dict__.get("_bpd")
        if b is None:
            b = self.bytes_in_memory() / pmax(1, self.shards)
            self.__dict__["_bpd"] = b
        return b

    def with_state(self, state: MemState) -> "TensorStat":
        return dataclasses.replace(self, state=state)

    @property
    def sig(self) -> Tuple:
        """Hashable identity for cost memoization: any field the cost model
        may consult.  Cached per instance (instances are never mutated in
        place — state changes go through ``with_state``/``replace``)."""
        s = self.__dict__.get("_sig")
        if s is None:
            s = (self.shape, self.dtype, self.sparsity, self.state.value,
                 self.shards)
            self.__dict__["_sig"] = s
        return s


class Recorder:
    """Captures one cacheable sub-walk of the cost estimator (§memoization).

    While active it accumulates (a) the *read set* — external variables the
    walk consulted, fingerprinted by the stat they had at first read; (b) the
    *write set* — names the walk mutated; and (c) the peak live-HBM
    excursion relative to the walk's start.  Because a matching read-set
    fingerprint guarantees an identical walk, the walk's effect can be
    summarized as the NET symbol-table delta (final stat per written name +
    one HBM byte delta) and applied in O(written) on every replay.
    """

    __slots__ = ("reads", "written", "start_hbm", "max_rel_hbm", "poisoned")

    def __init__(self, start_hbm: float) -> None:
        self.reads: Dict[str, Optional[Tuple]] = {}
        self.written: set = set()
        self.start_hbm = start_hbm
        self.max_rel_hbm = 0.0
        self.poisoned = False


class SymbolTable:
    """Name -> TensorStat with the paper's createvar/cpvar/rmvar semantics."""

    def __init__(self) -> None:
        self._vars: Dict[str, TensorStat] = {}
        self._hbm_bytes = 0.0          # incremental live-HBM accumulator
        self._recorders: list = []     # active Recorder stack (innermost last)

    def _acct(self, st: Optional[TensorStat], sign: float) -> None:
        if st is not None and st.state == MemState.HBM:
            self._hbm_bytes += sign * st.bytes_per_device()

    # --- recording (cost-memoization support) ---
    def begin_record(self) -> Recorder:
        rec = Recorder(self._hbm_bytes)
        self._recorders.append(rec)
        return rec

    def end_record(self, rec: Recorder) -> None:
        popped = self._recorders.pop()
        assert popped is rec, "unbalanced begin_record/end_record"
        if rec.poisoned and self._recorders:
            # a poisoned inner walk poisons every enclosing walk too
            self._recorders[-1].poisoned = True

    def net_delta(self, rec: Recorder) -> Dict[str, Optional[TensorStat]]:
        """Summarize a finished recording as name -> final stat (None means
        the walk removed the variable).  Read at end_record time, when the
        table holds the walk's final state."""
        get = self._vars.get
        return {name: get(name) for name in rec.written}

    def _note_read(self, name: str) -> None:
        for rec in self._recorders:
            if name not in rec.written and name not in rec.reads:
                st = self._vars.get(name)
                rec.reads[name] = st.sig if st is not None else None

    def matches(self, reads: Dict[str, Optional[Tuple]]) -> bool:
        """Probe: does the current table state fingerprint-match a recorded
        read set?  Pure query — registers nothing with active recorders."""
        get = self._vars.get
        for name, sig in reads.items():
            st = get(name)
            if st is None:
                if sig is not None:
                    return False
            else:
                ssig = st.__dict__.get("_sig")
                if ssig is None:
                    ssig = st.sig
                if ssig != sig:
                    return False
        return True

    def replay(self, reads: Dict[str, Optional[Tuple]],
               net: Dict[str, Optional[TensorStat]], hbm_delta: float,
               max_rel_hbm: float) -> float:
        """Re-apply a recorded walk's net effect: register its reads and
        writes with any enclosing recorders, overwrite the written names
        with their final stats, bump the live-HBM accumulator by the net
        delta, and return the absolute peak live-HBM the walk reaches."""
        start = self._hbm_bytes
        if self._recorders:
            for name in reads:
                self._note_read(name)
            peak = start + max_rel_hbm
            for rec in self._recorders:
                rec.written.update(net)
                rec.max_rel_hbm = max(rec.max_rel_hbm, peak - rec.start_hbm)
        variables = self._vars
        for name, stat in net.items():
            if stat is None:
                variables.pop(name, None)
            else:
                variables[name] = stat
        self._hbm_bytes = start + hbm_delta
        return start + max_rel_hbm

    # --- instruction analogues ---
    def createvar(self, name: str, stat: TensorStat) -> None:
        if self._recorders:
            # the overwrite delta depends on the old stat (absence included)
            self._note_read(name)
            for rec in self._recorders:
                rec.written.add(name)
        self._acct(self._vars.get(name), -1.0)
        self._vars[name] = stat
        self._acct(stat, +1.0)

    def cpvar(self, src: str, dst: str) -> None:
        if src in self._vars:   # __contains__ registers the read when recording
            self.createvar(dst, dataclasses.replace(self._vars[src]))

    def rmvar(self, *names: str) -> None:
        if self._recorders:
            for n in names:
                self._note_read(n)      # freed bytes depend on the stat
            for rec in self._recorders:
                rec.written.update(names)
        for n in names:
            self._acct(self._vars.get(n), -1.0)
            self._vars.pop(n, None)

    # --- queries/updates used by the cost estimator ---
    def get(self, name: str) -> Optional[TensorStat]:
        if self._recorders:
            self._note_read(name)
        return self._vars.get(name)

    def __contains__(self, name: str) -> bool:
        if self._recorders:
            self._note_read(name)
        return name in self._vars

    def __len__(self) -> int:
        return len(self._vars)

    def names(self):
        return list(self._vars)

    def state_of(self, name: str) -> Optional[MemState]:
        if self._recorders:
            self._note_read(name)
        st = self._vars.get(name)
        return st.state if st else None

    def touch_hbm(self, *names: str) -> None:
        """Mark variables device-resident (consumers after the first read free)."""
        for n in names:
            if self._recorders:
                self._note_read(n)
                for rec in self._recorders:
                    rec.written.add(n)
            st = self._vars.get(n)
            if st is not None and st.state != MemState.HBM:
                self._vars[n] = st.with_state(MemState.HBM)
                self._hbm_bytes += st.bytes_per_device()

    def set_state(self, name: str, state: MemState) -> None:
        if self._recorders:
            self._note_read(name)
            for rec in self._recorders:
                rec.written.add(name)
        st = self._vars.get(name)
        if st is not None:
            self._acct(st, -1.0)
            new = st.with_state(state)
            self._vars[name] = new
            self._acct(new, +1.0)

    def live_hbm_bytes(self, per_device: bool = True) -> float:
        if per_device:
            for rec in self._recorders:
                rec.max_rel_hbm = max(rec.max_rel_hbm,
                                      self._hbm_bytes - rec.start_hbm)
            return self._hbm_bytes
        return sum(st.bytes_in_memory() for st in self._vars.values()
                   if st.state == MemState.HBM)

    def snapshot(self) -> Dict[str, TensorStat]:
        return {k: dataclasses.replace(v) for k, v in self._vars.items()}

    def restore(self, snap: Dict[str, TensorStat]) -> None:
        # Wholesale state replacement cannot be expressed in the replay log,
        # so any walk that restores a snapshot is not cacheable.
        for rec in self._recorders:
            rec.poisoned = True
        self._vars = {k: dataclasses.replace(v) for k, v in snap.items()}
        self._hbm_bytes = sum(st.bytes_per_device()
                              for st in self._vars.values()
                              if st.state == MemState.HBM)

    def copy(self) -> "SymbolTable":
        t = SymbolTable()
        t.restore(self._vars)
        return t
