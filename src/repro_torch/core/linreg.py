"""The paper's running example: closed-form linear regression (LinReg DS).

Reproduces §2's plan generation end-to-end: given a scenario (X: m x n,
y: m x 1) and cluster characteristics, generate the runtime plan the way
SystemML's compiler does —

  * execution-type selection: CP (single device) when memory estimates fit
    the local budget, DIST otherwise (paper: CP vs MR);
  * physical operator selection for X^T X:
      - ``tsmm``        : local transpose-self matmul (CP),
      - ``tsmm+ak+``    : partial Gram per row-block + all-reduce aggregation
                          (paper's map-side tsmm w/ ak+ final aggregation) —
                          requires full rows per device (n <= block size),
      - ``cpmm``        : 2D-sharded matmul w/ reduce-scatter (+extra
                          shuffle) when rows don't fit a block;
  * physical operator selection for X^T y:
      - ``mapmm``       : broadcast the small side (y) and psum — requires y
                          to fit the broadcast (per-device) budget,
      - ``cpmm``        : shard both sides otherwise;
  * the (y^T X)^T rewrite in CP mode (avoids materializing X^T — paper
    applies it in XS but NOT in XL1 where the transpose would not fit);
  * partitioned broadcast of y (paper's `partition` CP instruction).

The generated :class:`Program` is then costed by the ordinary estimator —
producing the paper's Figures 4/5 — and the scenario sweep reproduces the
plan switches of Table 1 / §2.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.plan import (Collective, Compute, CreateVar, DataGen,
                                   GenericBlock, IfBlock, IO, Program, RmVar)
from repro_torch.core.symbols import MemState, TensorStat


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Paper Table 1 rows."""

    name: str
    m: int                # rows of X
    n: int                # cols of X
    intercept: int = 0
    dtype: str = "float64"   # SystemML matrices are double

    @property
    def x_bytes(self) -> float:
        return self.m * self.n * 8.0

    @property
    def y_bytes(self) -> float:
        return self.m * 8.0


# The paper's five scenarios (Table 1): 80 MB ... 3.2 TB.
SCENARIOS: Dict[str, Scenario] = {
    "XS": Scenario("XS", 10**4, 10**3),
    "XL1": Scenario("XL1", 10**8, 10**3),
    "XL2": Scenario("XL2", 10**8, 2 * 10**3),
    "XL3": Scenario("XL3", 2 * 10**8, 10**3),
    "XL4": Scenario("XL4", 2 * 10**8, 2 * 10**3),
}


@dataclasses.dataclass(frozen=True)
class CompilerBudgets:
    """The constraint structure driving the paper's decisions.

    ``local_mem``     — CP memory budget (paper: 1,434 MB = 70% of 2 GB heap)
    ``broadcast_mem`` — per-task budget for the mapmm broadcast operand
    ``block_size``    — matrix block (tile) width; tsmm's map-side variant
                        "requires to see entire rows of the input matrix"
    """

    local_mem: float = 1434e6
    broadcast_mem: float = 1434e6
    block_size: int = 1000


PAPER_BUDGETS = CompilerBudgets()


def tpu_budgets(cc: ClusterConfig) -> CompilerBudgets:
    """The same decision structure instantiated with TPU constants:
    local budget = one chip's usable HBM; broadcast budget = HBM reserve;
    block size = lane-aligned tile bound for a single-pass row kernel."""
    return CompilerBudgets(local_mem=cc.hbm_budget,
                           broadcast_mem=cc.hbm_budget * 0.25,
                           block_size=8192)


@dataclasses.dataclass
class PlanChoice:
    exec_type: str          # "CP" | "DIST"
    tsmm_op: str            # "tsmm" | "tsmm+ak+" | "cpmm"
    mm_op: str              # "mm" | "mapmm" | "cpmm"
    yt_rewrite: bool        # (y^T X)^T rewrite applied?
    partition_y: bool


def select_operators(sc: Scenario, cc: ClusterConfig,
                     budgets: CompilerBudgets) -> PlanChoice:
    """The paper's §2 decision procedure, verbatim in structure."""
    xb, yb = sc.x_bytes, sc.y_bytes
    # memory estimate of the tsmm/transpose HOPs ~ input + output (+X^T)
    cp_fits = (2 * xb + sc.n * sc.n * 8 + 2 * yb) <= budgets.local_mem
    if cp_fits:
        return PlanChoice("CP", "tsmm", "mm", yt_rewrite=True, partition_y=False)
    # distributed: operator constraints
    tsmm_ok = sc.n <= budgets.block_size          # needs whole rows per pass
    mapmm_ok = yb <= budgets.broadcast_mem        # broadcast operand fits
    return PlanChoice(
        "DIST",
        "tsmm+ak+" if tsmm_ok else "cpmm",
        "mapmm" if mapmm_ok else "cpmm",
        yt_rewrite=False,                          # X^T materialized remotely
        partition_y=mapmm_ok,                      # paper partitions broadcast y
    )


def build_linreg_program(sc: Scenario, cc: ClusterConfig,
                         budgets: CompilerBudgets = PAPER_BUDGETS) -> Tuple[Program, PlanChoice]:
    """Generate the runtime plan for LinReg DS under a scenario + cluster."""
    choice = select_operators(sc, cc, budgets)
    dist = choice.exec_type == "DIST"
    n_dev = cc.num_chips if dist else 1
    shard_axes = tuple(cc.mesh_axes) if dist else ()
    dt = sc.dtype

    prog = Program(name=f"LinregDS-{sc.name}")
    # persistent inputs on "HDFS" (disk)
    prog.inputs["X"] = TensorStat((sc.m, sc.n), dt, state=MemState.DISK,
                                  shards=n_dev)
    prog.inputs["y"] = TensorStat((sc.m, 1), dt, state=MemState.DISK,
                                  shards=n_dev if not choice.partition_y else 1)

    b1 = GenericBlock("lines 1-3 (read inputs, scalars)")
    # createvar/cpvar bookkeeping mirrors Fig. 2
    b1.children.append(CpVarLike("pREADX", "X"))
    b1.children.append(CpVarLike("pREADy", "y"))
    prog.blocks.append(b1)

    # intercept branch (constant-folded away when intercept==0, Fig. 1)
    if sc.intercept == 1:
        br = GenericBlock("lines 4-7 (append intercept column)")
        br.children.append(DataGen("rand", "ones",
                                   TensorStat((sc.m, 1), dt, shards=n_dev)))
        br.children.append(Compute("concat", ("X", "ones"), "X",
                                   exec_type=choice.exec_type,
                                   shard_axes=shard_axes, attrs={"axis": 1}))
        prog.blocks.append(br)

    core = GenericBlock("lines 8-12 (normal equations + solve)")
    A = core.children.append
    # lambda*I via rand+rdiag (the paper's rewritten diag(matrix(lambda,...)))
    A(DataGen("rand", "_mVarI", TensorStat((sc.n, 1), dt)))
    A(Compute("rdiag", ("_mVarI",), "_mVarD", exec_type="CP"))

    if choice.partition_y:
        # CP partition instruction: stage y into block-partitioned form
        A(IO("read", "y", src=MemState.DISK, dst=MemState.HOST))
        A(IO("read", "y", src=MemState.HOST, dst=MemState.HBM))

    # ---- X^T X ----
    if choice.tsmm_op == "tsmm":
        A(Compute("tsmm", ("X",), "_mVarA", exec_type="CP"))
    elif choice.tsmm_op == "tsmm+ak+":
        A(Compute("tsmm", ("X",), "_mVarA", exec_type="DIST",
                  shard_axes=shard_axes))
        A(Collective("all_reduce", "_mVarA", shard_axes))
    else:  # cpmm: 2D sharding, X shuffled, reduce-scatter + gather
        A(Compute("transpose", ("X",), "_mVarXt", exec_type="DIST",
                  shard_axes=shard_axes))
        A(Compute("matmul", ("_mVarXt", "X"), "_mVarA", exec_type="DIST",
                  shard_axes=shard_axes))
        A(Collective("reduce_scatter", "_mVarA", shard_axes))
        A(Collective("all_gather", "_mVarA", shard_axes,
                     bytes_override=sc.n * sc.n * 8 / n_dev))

    # ---- X^T y ----
    if choice.exec_type == "CP":
        if choice.yt_rewrite:   # (y^T X)^T — avoids transposing X (Fig. 2)
            A(Compute("transpose", ("y",), "_mVarYt", exec_type="CP"))
            A(Compute("matmul", ("_mVarYt", "X"), "_mVarBt", exec_type="CP"))
            A(Compute("transpose", ("_mVarBt",), "_mVarB", exec_type="CP"))
        else:
            A(Compute("transpose", ("X",), "_mVarXt", exec_type="CP"))
            A(Compute("matmul", ("_mVarXt", "y"), "_mVarB", exec_type="CP"))
    elif choice.mm_op == "mapmm":
        # broadcast y (already partitioned), transpose X remotely — but
        # piggybacked into the SAME pass as tsmm (shared scan of X): we model
        # the shared scan by the symbol table: X is HBM-resident after tsmm.
        A(Compute("transpose", ("X",), "_mVarXt", exec_type="DIST",
                  shard_axes=shard_axes))
        A(Compute("matmul", ("_mVarXt", "y"), "_mVarB", exec_type="DIST",
                  shard_axes=shard_axes))
        A(Collective("all_reduce", "_mVarB", shard_axes))
    else:  # cpmm for X^T y
        A(Compute("transpose", ("X",), "_mVarXt2", exec_type="DIST",
                  shard_axes=shard_axes))
        A(Compute("matmul", ("_mVarXt2", "y"), "_mVarB", exec_type="DIST",
                  shard_axes=shard_axes))
        A(Collective("reduce_scatter", "_mVarB", shard_axes))
        A(Collective("all_gather", "_mVarB", shard_axes,
                     bytes_override=sc.n * 8 / n_dev))

    # ---- A + lambda*I; solve; write ----
    A(Compute("add", ("_mVarA", "_mVarD"), "_mVarA2", exec_type="CP"))
    A(Compute("solve", ("_mVarA2", "_mVarB"), "beta", exec_type="CP"))
    A(IO("write", "beta", src=MemState.HBM, dst=MemState.DISK))
    A(RmVar(("_mVarI", "_mVarD", "_mVarA", "_mVarA2", "_mVarB")))
    prog.blocks.append(core)
    return prog, choice


def CpVarLike(src: str, dst: str):
    # cosmetic alias so EXPLAIN shows the paper's cpvar pREADX X lines
    from repro_torch.core.plan import CpVar
    return CpVar(src, dst)
