"""Training runtime: the train step factory and the orchestration loop
(counterpart of ``repro.runtime.train_loop``).

``make_train_step`` assembles the step that the plan's decision vector
describes: the remat policy, microbatch accumulation, gradient compression
and AdamW.  PyTorch runs it eagerly, one kernel after another, where the
reference compiles it into one program; the arithmetic is the reference's.
The step runs as well on ``DTensor`` trees (the sharded ``Trainer``): each
gradient is reduced once, into its moments' placements (the data-parallel
reduce), microbatches split the local shard of the batch (no gather of the
tokens), and plain tensors the model makes (positions, masks) count as
replicated.

``Trainer`` adds the operational shell: cost-based plan selection, the
prefetching data pipeline, async checkpointing and resume, the straggler
monitor, and the online recalibrator, on one device or, given a
``DeviceMesh``, with the parameters, AdamW state and batches placed by the
plan's shardings (``launch/shardings.py``).

``OnlineRecalibrator`` closes the estimate-against-reality loop at run
time: it watches the measured/estimated step-time ratio (EWMA), refits a
:class:`repro_torch.core.calibration.CalibrationProfile` when the drift
leaves a band, and, only when the re-costed plan ranking changes, routes
through :func:`repro_torch.runtime.elastic.replan` to switch plans.  It
holds no arrays and decides bit for bit as the reference does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.calibration import (CalibrationProfile,
                                          CalibrationSample,
                                          features_from_totals, fit_profile)
from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.costmodel import PlanCostCache, VPU_FRACTION, estimate
from repro_torch.core.planner import (OVERLAP_FRACTION, ShardingPlan,
                                      build_step_program, choose_plan)
from repro_torch.data.pipeline import make_pipeline
from repro_torch.models.model import Model, build_model
from repro_torch.models.sharded import is_dtensor, split_batch
from repro_torch.optim import adamw, compress
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime.straggler import StepTimeMonitor


def value_and_grad(model: Model, params: Any, batch: Dict[str, torch.Tensor],
                   *, remat: str = "none", use_kernel: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, grads) of ``model.loss`` at ``params``: the gradient
    of every leaf of the tree, by ``torch.autograd.grad`` over the leaves
    (detached aliases that require a gradient, so no ``.grad`` field is
    written and ``params`` is left as it is).  A leaf the loss does not
    reach gets ``None``.  A ``DTensor`` leaf's gradient comes back as
    autograd leaves it (a partial sum over the data-parallel ranks, say):
    the train step reduces it."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch, remat=remat,
                                   use_kernel=use_kernel)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                         allow_unused=True))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), live))


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    plan: ShardingPlan, *, compress_scheme: str = "none",
                    use_kernel: bool = False,
                    donate: bool = False) -> Callable:
    """Returns ``train_step(params, opt_state, ef_state, batch) -> (params,
    opt_state, ef_state, metrics)``, a function of its arguments: new trees
    come back, the given ones are not written.  With ``donate`` the given
    params and opt_state are updated in place and come back as the new ones
    (the same numbers; the reference's trainer donates them to its jitted
    step): the step then never holds two copies of the weights and the fp32
    moments.

    With ``plan.microbatches`` > 1 the batch is split along its first axis
    and the gradients are summed in fp32, each divided by the count, as the
    reference's ``lax.scan`` does; no per-microbatch metrics come back.  A
    leaf the loss does not reach gets a zero gradient, as under
    ``jax.grad``.  metrics: ``loss``, ``grad_norm``, ``lr`` and, with one
    microbatch, ``ce`` and ``aux``.

    On ``DTensor`` trees the gradients are summed over the microbatches as
    autograd leaves them and reduced once, into the moments' placements
    (a reduce-scatter under ZeRO-1, as GSPMD reduces into the update);
    AdamW writes the new weights back in the weights' placements."""
    micro = max(plan.microbatches, 1)

    def grads_of(params, batch):
        loss, metrics, grads = value_and_grad(
            model, params, batch, remat=plan.remat, use_kernel=use_kernel)
        grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g,
                         grads, params)
        return loss, metrics, grads

    def train_step(params, opt_state, ef_state, batch):
        if not is_dtensor(tree_leaves(params)[0]):
            return step(params, opt_state, ef_state, batch)
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return step(params, opt_state, ef_state, batch)

    def step(params, opt_state, ef_state, batch):
        if micro > 1:
            parts = {k: split_batch(v, micro) for k, v in batch.items()}
            if any(len(v) != micro or v[0].shape[0] * micro != t.shape[0]
                   for v, t in zip(parts.values(), batch.values())):
                raise ValueError(f"batch of {next(iter(batch.values())).shape[0]} "
                                 f"does not split into {micro} microbatches")
            grads, loss = None, 0.0
            for i in range(micro):
                l_i, _, g_i = grads_of(params, {k: v[i]
                                                for k, v in parts.items()})
                g_i = tree_map(lambda g: g.to(torch.float32) / micro, g_i)
                # the first is kept as it is (0 + g is g): an accumulator
                # of zeros would be placed unlike a partial gradient
                grads = g_i if grads is None else tree_map(
                    lambda a, g: a.add_(g), grads, g_i)
                loss = loss + l_i / micro
            metrics: Dict[str, Any] = {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        grads = tree_map(adamw.placed_like, grads, opt_state.m)
        grads, ef_state = compress.compress_grads(grads, ef_state,
                                                  compress_scheme)
        new_params, new_opt, opt_metrics = adamw.apply(opt_cfg, opt_state,
                                                       grads, params,
                                                       donate=donate)
        return new_params, new_opt, ef_state, {"loss": loss, **opt_metrics,
                                               **metrics}

    return train_step


def _mesh_device(mesh) -> torch.device:
    """The device this process drives on ``mesh``: the current CUDA device
    of a cuda mesh (``init_device_mesh`` sets it), else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------------
# Online recalibration (estimate↔reality loop)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecalibrationEvent:
    """One drift-triggered refit: the EWMA ratio that tripped the band,
    the profile fitted from it, and — when the re-costed ranking changed —
    the elastic replan that switches the job onto the new winner."""

    step: int
    ratio: float                        # EWMA measured/estimated at refit
    profile: CalibrationProfile
    replanned: bool
    old_plan: str
    new_plan: str
    elastic: Optional[Any] = None       # ElasticPlan when replanned


class OnlineRecalibrator:
    """Maintains an EWMA of measured/estimated step time and refits the
    calibration profile when drift leaves the band.

    The refit path: the incumbent plan's charged :class:`ProgramTotals`
    become one peak-rate feature vector (``features_from_totals``), the
    EWMA measured time its target, and :func:`fit_profile`'s min-norm
    least squares distributes the drift across the plan's term mix —
    comm-heavy drift lands mostly on the fabric factors, compute-heavy
    drift on the MXU factors.  The candidate ranking is then re-costed
    under the fitted profile (through the shared :class:`PlanCostCache`;
    the calibration-aware cluster fingerprint keeps calibrated and
    uncalibrated entries apart) and :func:`repro_torch.runtime.elastic.replan`
    fires only when the winner actually changes — a uniform slowdown
    rescales every candidate and changes nothing, which is exactly the
    "not merely when the ratio moves" contract.
    """

    def __init__(self, arch: ArchConfig, shape: ShapeConfig,
                 cc: ClusterConfig, *,
                 plan: Optional[ShardingPlan] = None,
                 band: Tuple[float, float] = (0.85, 1.18),
                 alpha: float = 0.25,
                 min_observations: int = 8,
                 cooldown_steps: int = 16,
                 candidates: Optional[List[ShardingPlan]] = None,
                 cache: Optional[PlanCostCache] = None):
        self.arch, self.shape = arch, shape
        self.cc = cc
        self.band = band
        self.alpha = alpha
        self.min_observations = min_observations
        self.cooldown_steps = cooldown_steps
        # an optional vetted plan family: both the ranking check and the
        # elastic replan stay inside it (None = the full enumeration)
        self.candidates = list(candidates) if candidates is not None else None
        self.cache = cache if cache is not None else PlanCostCache()
        self.events: List[RecalibrationEvent] = []
        if plan is None:
            plan = choose_plan(arch, shape, cc, top_k=1,
                               candidates=self.candidates,
                               cache=self.cache)[0].plan
        self._n = 0
        self._step = 0
        self._last_refit: Optional[int] = None
        self.ewma: Optional[float] = None
        self._set_plan(plan)

    # ------------------------------------------------------------------
    def _set_plan(self, plan: ShardingPlan) -> None:
        """Re-cost the incumbent plan under the current (possibly
        calibrated) cc: the estimate the measured ratio is taken against,
        its charged totals (the refit features), and the non-calibratable
        part of the estimate (VPU work, IO, latency)."""
        cc_p = self.cc.with_overlap(OVERLAP_FRACTION if plan.overlap else 0.0)
        est = estimate(build_step_program(self.arch, self.shape, plan, cc_p),
                       cc_p, cache=self.cache)
        self.plan = plan
        self.estimated = est.total
        self._totals = est.totals
        vpu_t = est.totals.vpu_flops / (cc_p.chip.peak("float32")
                                        * VPU_FRACTION)
        self._fixed = est.breakdown.io + est.breakdown.latency + vpu_t

    # ------------------------------------------------------------------
    def observe(self, measured_seconds: float,
                step: Optional[int] = None) -> Optional[RecalibrationEvent]:
        """Feed one measured step time; returns a
        :class:`RecalibrationEvent` when drift triggered a refit."""
        self._n += 1
        self._step = step if step is not None else self._n
        ratio = measured_seconds / self.estimated
        self.ewma = (ratio if self.ewma is None
                     else (1.0 - self.alpha) * self.ewma + self.alpha * ratio)
        if self._n < self.min_observations:
            return None
        if self.band[0] <= self.ewma <= self.band[1]:
            return None
        if (self._last_refit is not None
                and self._step - self._last_refit < self.cooldown_steps):
            return None
        return self._refit()

    # ------------------------------------------------------------------
    def _refit(self) -> RecalibrationEvent:
        from repro_torch.runtime import elastic

        self._last_refit = self._step
        measured = self.ewma * self.estimated
        sample = CalibrationSample(
            features=features_from_totals(self._totals, self.cc),
            measured_seconds=measured,
            estimated_seconds=self.estimated,
            # the fixed offset can't exceed the measurement it is
            # subtracted from (clock noise on very fast steps)
            fixed_seconds=min(self._fixed, 0.5 * measured),
            label=f"online:{self.plan.name}@{self._step}")
        profile = fit_profile([sample], chip_name=self.cc.chip.name).profile
        new_cc = self.cc.with_calibration(profile)
        winner = choose_plan(self.arch, self.shape, new_cc, top_k=1,
                             candidates=self.candidates,
                             cache=self.cache)[0].plan
        replanned = winner != self.plan
        event = RecalibrationEvent(
            step=self._step, ratio=self.ewma, profile=profile,
            replanned=replanned, old_plan=self.plan.describe(),
            new_plan=winner.describe())
        old_plan = self.plan
        self.cc = new_cc
        if replanned:
            event.elastic = elastic.replan(
                self.arch, self.shape, old_cc=new_cc,
                new_mesh_shape=new_cc.mesh_shape,
                new_mesh_axes=new_cc.mesh_axes,
                candidates=self.candidates, cache=self.cache)
            self.cc = event.elastic.cc
            self._set_plan(event.elastic.decision.plan)
        else:
            self._set_plan(old_plan)
        # rebase the EWMA against the calibrated estimate: the fit just
        # explained the drift, so the loop restarts near ratio 1 and only
        # *new* drift can trip the band again
        self.ewma = measured / self.estimated if not replanned else None
        self._n = 0 if replanned else self._n
        self.events.append(event)
        return event


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    ckpt_dir: Optional[str] = None
    seed: int = 0
    compress_scheme: str = "none"
    # None: the kernel path whenever the device is CUDA (as ServeEngine
    # decides); a caller may switch it off to hold the two paths apart
    use_kernel: Optional[bool] = None
    donate: bool = True
    # Enable the online estimate<->reality loop: an OnlineRecalibrator
    # watches measured step times and refits the calibration profile when
    # drift leaves its band (see OnlineRecalibrator for the replan rule).
    recalibrate: bool = False


class Trainer:
    """End-to-end orchestration on one device: the GPU unless
    ``device="cpu"`` is given (building it raises when CUDA is absent;
    nothing falls back to the CPU); or, given a ``DeviceMesh`` in place of
    the device (the reference's ``Trainer(arch, shape, cc, mesh, ...)``),
    on every rank of that mesh, each process driving its own device.

    On a mesh, the parameters, the AdamW state (ZeRO-1 moments under
    ``plan.zero1``) and each batch are ``DTensor``s placed by the plan's
    shardings (``launch.shardings``); every rank makes the same weights and
    batches from the seed and keeps its shard.  The kernels see local
    tensors only (``models.sharded.local_call``).  A checkpoint is gathered
    on every rank and written by rank 0, in the one format; resume places
    it back by the shardings.

    The checkpoint holds ``{"params", "opt"}``, as the reference's does, so
    each package resumes the other's checkpoints; the error-feedback
    residual of ``compress_scheme="int8_ef"`` is not in it and restarts
    from zero on resume.  Each step's seconds are read after the device has
    finished it (``torch.cuda.synchronize``), so the straggler monitor and
    the recalibrator see execution time, not launch time.

    On the GPU, set ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``
    before the process first touches CUDA (``launch/train.py`` does): the
    larger archs' AdamW temporaries find no room in the memory the caching
    allocator holds reserved without it.  A ``Trainer`` cannot set it once
    CUDA has allocated."""

    def __init__(self, arch: ArchConfig, shape: ShapeConfig,
                 cc: ClusterConfig,
                 device: Union[str, torch.device, Any] = "cuda", *,
                 plan: Optional[ShardingPlan] = None,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 tcfg: Optional[TrainerConfig] = None):
        self.arch, self.shape, self.cc = arch, shape, cc
        self.mesh = None
        if not isinstance(device, (str, torch.device)):
            self.mesh, device = device, _mesh_device(device)
        self.model = build_model(arch, device)
        self.device = self.model.device
        self.tcfg = tcfg or TrainerConfig()
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            total_steps=self.tcfg.steps)
        if plan is None:
            plan = choose_plan(arch, shape, cc, top_k=1)[0].plan
        self.plan = plan
        self.use_kernel = (self.device.type == "cuda"
                           if self.tcfg.use_kernel is None
                           else self.tcfg.use_kernel)
        self.train_step = make_train_step(
            self.model, self.opt_cfg, plan,
            compress_scheme=self.tcfg.compress_scheme,
            use_kernel=self.use_kernel, donate=self.tcfg.donate)
        self.monitor = StepTimeMonitor()
        self.recalibrator = (OnlineRecalibrator(arch, shape, cc,
                                                plan=self.plan)
                             if self.tcfg.recalibrate else None)
        self.checkpointer = (store.AsyncCheckpointer(self.tcfg.ckpt_dir)
                             if self.tcfg.ckpt_dir else None)
        self.rank = 0 if self.mesh is None else self.mesh.get_rank()

    # ------------------------------------------------------------------
    def shardings(self, params, opt_state=None):
        """The plan's shardings of ``params`` (and of ``opt_state``) on the
        mesh: ``{"params", "opt"}``, or ``None`` without a mesh."""
        if self.mesh is None:
            return None
        from repro_torch.launch import shardings as S

        psh = S.params_shardings(self.mesh, self.plan, params)
        out = {"params": psh}
        if opt_state is not None:
            out["opt"] = S.opt_state_shardings(self.mesh, self.plan, psh,
                                               opt_state)
        return out

    def place_batch(self, batch: Dict[str, torch.Tensor]):
        """A global batch (the same on every rank) as ``DTensor``s sharded
        by the plan's batch shardings; as it is without a mesh."""
        if self.mesh is None:
            return batch
        from repro_torch.launch import shardings as S

        return S.place_tree(batch, S.batch_shardings(self.mesh, self.plan,
                                                     batch))

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None):
        """(params, AdamW state, error-feedback state) on the device, the
        weights from ``seed`` (default ``tcfg.seed``)."""
        seed = self.tcfg.seed if seed is None else seed
        if self.mesh is None:
            params = self.model.init(seed)
            opt_state = adamw.init(self.opt_cfg, params)
        else:
            params, opt_state = self._init_placed(seed)
        if self.tcfg.compress_scheme == "int8_ef":
            ef = compress.init_error_feedback(params)
        else:
            ef = compress.EFState(residual=tree_map(
                lambda p: torch.zeros((), dtype=torch.float32,
                                      device=p.device), params))
        return params, opt_state, ef

    def _init_placed(self, seed: int):
        """The weights and zero moments made in their placements: each
        rank draws the one-device init's numbers and keeps its shards
        (``shardings.init_params``), and makes its shards of the moments
        (ZeRO-1's under ``plan.zero1``) only."""
        from repro_torch.launch import shardings as S

        params, psh = S.init_params(self.model, seed, self.mesh, self.plan)
        osh = S.opt_state_shardings(self.mesh, self.plan, psh,
                                    adamw.AdamWState(0, params, params))
        mdt = adamw.moment_dtype(self.opt_cfg)

        def zeros(p, sh):
            return S.zeros(p.shape, mdt, sh, self.device)
        return params, adamw.AdamWState(
            step=0, m=tree_map(zeros, params, osh.m),
            v=tree_map(zeros, params, osh.v))

    def maybe_resume(self, params, opt_state):
        """The newest checkpoint of ``tcfg.ckpt_dir`` restored onto the
        device, and the step to resume at (the checkpoint holds the state
        after its step); the given state and 0 when there is none."""
        if not self.tcfg.ckpt_dir:
            return params, opt_state, 0
        if store.latest_step(self.tcfg.ckpt_dir) is None:
            return params, opt_state, 0
        restored, step = store.restore(
            self.tcfg.ckpt_dir, {"params": params, "opt": opt_state},
            device=self.device, shardings=self.shardings(params, opt_state))
        return restored["params"], restored["opt"], step + 1

    def run(self, *, start_step: int = 0, params=None, opt_state=None,
            ef=None, on_metrics: Optional[Callable] = None) -> Dict[str, Any]:
        """Train from ``start_step`` to ``tcfg.steps``: from the given state,
        or (``params=None``) from :meth:`init_state` and
        :meth:`maybe_resume`.  Returns the final state and the logged
        metrics (``history``: ``step``, ``time_s`` and the step's metrics as
        floats, every ``log_every`` steps)."""
        if params is None:
            params, opt_state, ef = self.init_state()
            params, opt_state, start_step = self.maybe_resume(params,
                                                              opt_state)
        fshape = self.model.frontend_shape(self.shape.global_batch)
        pipe = make_pipeline(self.arch.vocab_size, self.shape.seq_len,
                             self.shape.global_batch, seed=self.tcfg.seed,
                             frontend_shape=fshape, device=self.device,
                             start_step=start_step)
        on_cuda = self.device.type == "cuda"
        history = []
        try:
            for gstep, batch in pipe:
                if gstep >= self.tcfg.steps:
                    break
                t0 = time.perf_counter()
                params, opt_state, ef, metrics = self.train_step(
                    params, opt_state, ef, self.place_batch(batch))
                if on_cuda:
                    torch.cuda.synchronize(self.device)
                metrics = {k: float(v.full_tensor() if is_dtensor(v) else v)
                           for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self.monitor.record({0: dt})
                if self.recalibrator is not None:
                    # observation only: acting on a replan stays with the
                    # caller, who reads .events / the returned history
                    self.recalibrator.observe(dt, step=gstep)
                if gstep % self.tcfg.log_every == 0:
                    history.append({"step": gstep, "time_s": dt, **metrics})
                    if on_metrics:
                        on_metrics(history[-1])
                if (self.checkpointer and gstep > 0
                        and gstep % self.tcfg.checkpoint_every == 0):
                    # every rank gathers its shards; rank 0 writes
                    self.checkpointer.save(
                        gstep, {"params": params, "opt": opt_state},
                        write=self.rank == 0)
        finally:
            pipe.close()
            if self.checkpointer:
                self.checkpointer.wait()
        return {"params": params, "opt_state": opt_state, "ef": ef,
                "history": history}
