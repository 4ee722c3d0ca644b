"""Component-level costing of the generated plan: the counterpart of the
reference's ``launch/component_cost.py``.

The paper's methodology: cost each *instruction* of the runtime program and
aggregate over the program structure (Eq 1).  Here the instructions are the
per-layer components of the eager program, each traced once through
:func:`repro_torch.core.graph_cost.lower_and_cost` on fake tensors at the
step's widths and multiplied by its count:

    step_cost = sum_i  count_i * CompiledCost(component_i)

The reference costs components because XLA visits a scanned layer body
once; eager dispatch sees every layer, but a whole step at full width takes
seconds to trace, and a component a fraction of a second.

Components per architecture family (the reference's names and counts):
  * dense, vlm : ``decoder_layer`` x n_layers (vlm: over ``shape.seq_len``
    positions, the prepended patches not counted, as in the reference)
  * ssm     : ``mamba_layer``   x n_layers
  * hybrid  : ``mamba_layer`` x n_layers + ``shared_attn`` x its applications
  * dense with a window pattern: ``layer_w{w}`` for each distinct window
    ``w`` of the pattern (``layer_wglobal`` for ``None``) x its layers, the
    window cut to ``min(w, seq_len)``, a decode component with its position's
    ring cache (``p{i}``, the first position of that window)
  * enc-dec : ``encoder_layer`` x n_encoder_layers (prefill and train only:
    decode reads the cached cross K/V) over the ``encoder_seq`` frames, and
    ``decoder_layer`` x n_layers, with the cross K/V of the encoder's
    output computed inside it at prefill and train, read from the cache
    (``ck``, ``cv``) beside the self-attention cache's slice at decode
  * moe     : ``dense_layer`` x first_dense_layers (when there are any) and
    ``moe_layer`` x the rest, decode with the ``dense`` / ``moe`` cache
    group's slice (with MLA the 3-D latent slices ``ckv`` and ``krope``);
    the moe layer routes the component's ``B*S`` tokens (B at decode) in
    the reference's groups, its shared expert beside them; MLA's prefill
    and train components run dense attention, its decode the absorbed
    path (the MTP head is not a component, as in the reference)
  plus a tail: ``ce_head``, ``embed``, ``optimizer`` and (see below)
  ``grad_reduce`` for train, ``lm_head`` for serve.  Layer counts are multiplied by the microbatches.
  Decode components carry their layer's cache slice, so the cache traffic is
  costed.  A train component runs its forward under the plan's remat policy
  (``transformer._remat_wrap``), then its backward with a ones cotangent.

On a ``DeviceMesh`` (the fake process group of the dry run) the
components are the reference's local plan: each layer component is traced
as ONE data-parallel replica, the batch pre-sliced by the dp degree and the
sequence by the sp degree, the dp and sp axes dropped from the activations
and caches, while the parameters keep the whole plan's shardings (TP, FSDP
and EP axes) as fake ``DTensor``s, so DTensor generates their collectives
and ``graph_cost`` counts them, per device.  The real step accumulates the
gradients locally and reduces them once: ``grad_reduce``, one all-reduce
of every gradient's local shard over the dp axes in
``plan.grad_reduce_dtype``, when those axes hold more than one device and
there is no fsdp.  The optimizer runs on the whole trees, placed by the
plan's parameter and AdamW (ZeRO-1) shardings.

Where the port differs: prefill's ``lm_head`` heads the last position only,
as both packages' ``prefill`` does (the reference's component heads every
position).  What is traced is the plain program (the kernel wrappers see
CPU tensors), as ``graph_cost`` says.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import Counter
from typing import Any, Callable, Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.graph_cost import lower_and_cost, mesh_devices
from repro_torch.core.hlo_cost import CompiledCost
from repro_torch.core.planner import ShardingPlan
from repro_torch.launch import shardings as S
from repro_torch.models import transformer as T
from repro_torch.models.sharded import replicate_dims
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map


@dataclasses.dataclass
class Component:
    name: str
    count: int
    cost: CompiledCost


def _train_wrap(fwd: Callable, remat: str) -> Callable:
    """``fwd(p, x)`` under ``remat``, then its backward with a ones
    cotangent: returns (y.sum(), the gradients of p's leaves and of x)."""
    inner = T._remat_wrap(fwd, remat)

    def wrapped(p, x):
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            y = inner(p, x)
            grads = torch.autograd.grad(y, tree_leaves(p) + [x],
                                        torch.ones_like(y), allow_unused=True)
        return y.detach().sum(), grads
    return wrapped


def _grads_of(fn: Callable, wrt: Callable) -> Callable:
    """``fn(*args)`` (a scalar) and its gradients with respect to the
    leaves ``wrt(args)`` picks (made to require a gradient first)."""
    def wrapped(*args):
        args = tree_map(lambda t: t.detach(), list(args))
        leaves = wrt(args)
        for t in leaves:
            t.requires_grad_()
        with torch.enable_grad():
            y = fn(*args)
            grads = torch.autograd.grad(y, leaves, allow_unused=True)
        return y.detach(), grads
    return wrapped


class _Placer:
    """Fake ``DTensor``s of a component's operands on ``mesh`` under the
    plan's shardings (the reference's ``_param_specs``, ``_act_spec`` and
    ``_cache_slice_specs``); without a mesh, the plain views."""

    def __init__(self, mesh, plan: ShardingPlan):
        self.mesh, self.plan = mesh, plan
        self.local_plan = (None if mesh is None else dataclasses.replace(
            plan, batch_axes=(), seq_axes=()))

    def layer(self, stacked: Any, prefix: str, drop_stack: bool = True):
        """One layer of ``stacked`` (all of it without ``drop_stack``), each
        leaf sharded as the stacked leaf's spec says, less its stack dim."""
        if self.mesh is None:
            return T._layer(stacked, 0) if drop_stack else stacked

        def one(path, leaf):
            key = f"{prefix}/{path}"
            spec = list(S.param_sharding(self.mesh, self.plan, key,
                                         tuple(leaf.shape)).spec)
            spec += [None] * (leaf.ndim - len(spec))
            if drop_stack:
                spec, leaf = spec[1:], leaf[0]
            return S.place(leaf, S.Sharding(self.mesh, tuple(spec)))
        return S.map_with_paths(one, stacked)

    def replicated(self, t: torch.Tensor, *spec) -> torch.Tensor:
        """``t`` under ``spec`` (replicated when empty)."""
        if self.mesh is None:
            return t
        return S.place(t, S.Sharding(self.mesh, tuple(spec)))

    def cache_slice(self, group: Any):
        """Layer 0 of a cache group, sharded as the reference's
        ``_cache_slice_specs`` shards one layer's slice."""
        if group is None:
            return None
        layer = T._layer(group, 0)
        if self.mesh is None:
            return layer
        mesh, plan = self.mesh, self.local_plan
        out = {}
        for key, t in layer.items():
            shp, nd = t.shape, t.ndim
            if key == "kpos":
                out[key] = self.replicated(t)
                continue
            b = _guarded(mesh, shp[0], plan.batch_axes)
            if nd == 4:      # [B, H, cap, hd] kv  / [B, H, P, N] ssm state
                h = _guarded(mesh, shp[1], plan.tp_axes)
                s = None
                if b is None and key in ("k", "v"):
                    s = _guarded(mesh, shp[2], plan.batch_axes)
                out[key] = self.replicated(t, b, h, s, None)
            elif nd == 3:    # [B, S, r] mla latent / [B, W-1, C] conv
                s = None
                if b is None and key in ("ckv", "krope"):
                    s = _guarded(mesh, shp[1], plan.batch_axes)
                out[key] = self.replicated(t, b, s, None)
            else:
                out[key] = self.replicated(t, b, *([None] * (nd - 1)))
        return out


def _guarded(mesh, dim: int, axes):
    """The reference's ``_guarded``: ``shardings._guard`` over the axes the
    mesh has."""
    sizes = S.mesh_axes(mesh)
    return S._guard(mesh, dim, tuple(a for a in axes if a in sizes))


def component_costs(arch: ArchConfig, shape: ShapeConfig, plan: ShardingPlan,
                    mesh=None) -> List[Component]:
    """The step of ``arch`` at ``shape`` under ``plan``, component by
    component (see the module's docstring): on one device for ``mesh``
    ``None``, else per device of the ``DeviceMesh``."""
    if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
        mesh_devices(mesh)          # a list of one device (more raise)
        mesh = None
    cfg = arch
    model = build_model(cfg, device="cpu")      # raises for unported families
    mode = shape.mode
    dtype = T.torch_dtype(cfg.dtype)
    micro = max(plan.microbatches, 1) if mode == "train" else 1
    batch = max(shape.global_batch // micro, 1)
    q_len = 1 if mode == "decode" else shape.seq_len
    kv_len = shape.seq_len
    d = cfg.d_model
    place = _Placer(mesh, plan)
    if mesh is not None:
        # one data-parallel replica: the batch and sequence pre-sliced
        batch = max(batch // S._axis_size(mesh, plan.batch_axes), 1)
        if mode != "decode":
            q_len = max(q_len // S._axis_size(mesh, plan.seq_axes), 1)

    with FakeTensorMode():
        params = model.init(0)
        cache = model.init_cache(batch, kv_len) if mode == "decode" else None
        x = place.replicated(torch.empty((batch, q_len, d), dtype=dtype))
    comps: List[Component] = []

    def cost(name: str, count: int, fn: Callable, args) -> None:
        if mesh is not None:
            from torch.distributed.tensor.experimental import (
                implicit_replication)

            def run(*a, _fn=fn):
                with implicit_replication():
                    return _fn(*a)
        else:
            run = fn
        comps.append(Component(name, count,
                               lower_and_cost(name, run, args, mesh)[1]))

    def attn_fwd(p, x, window=None, moe=False):
        pos = T._positions(x.shape[0], x.shape[1], x.device)
        return T.block_apply(cfg, p, x, positions=pos, window=window,
                             moe=moe)[0]

    def attn_decode(p, x, c, window=None, moe=False):
        pos = torch.full((x.shape[0], 1), kv_len - 1, dtype=torch.int32)
        out, c2, _ = T.block_apply(cfg, p, x, positions=pos, window=window,
                                   moe=moe, kv_cache=c, pos=kv_len - 1)
        return out, c2

    def mamba_fwd(p, x):
        return T.mamba_layer_apply(cfg, p, x, None)[0]

    def mamba_decode(p, x, c):
        return T.mamba_layer_apply(cfg, p, x, c)[:2]

    def add_layer(name: str, count: int, p, fwd, decode, c=None) -> None:
        if mode == "decode":
            cost(name, count * micro, decode, (p, x, c))
        else:
            fn = _train_wrap(fwd, plan.remat) if mode == "train" else fwd
            cost(name, count * micro, fn, (p, x))

    if cfg.enc_dec is not None:
        _enc_dec_layers(cfg, params, cache, x, mode, plan, micro, kv_len,
                        cost, place)
    elif cfg.window_pattern is not None:
        pattern = cfg.window_pattern
        n_cycles = cfg.n_layers // len(pattern)
        for w, cnt in Counter(pattern).items():
            i = pattern.index(w)
            eff = None if w is None else min(w, kv_len)
            add_layer(f"layer_w{w or 'global'}", n_cycles * cnt,
                      place.layer(params["cycles"][i], "blocks"),
                      functools.partial(attn_fwd, window=eff),
                      functools.partial(attn_decode, window=eff),
                      place.cache_slice(cache and cache[f"p{i}"]))
    elif cfg.moe is not None:
        nd = cfg.moe.first_dense_layers
        if nd:
            add_layer("dense_layer", nd,
                      place.layer(params["dense_blocks"], "blocks"),
                      attn_fwd, attn_decode,
                      place.cache_slice(cache and cache["dense"]))
        add_layer("moe_layer", cfg.n_layers - nd,
                  place.layer(params["blocks"], "blocks"),
                  functools.partial(attn_fwd, moe=True),
                  functools.partial(attn_decode, moe=True),
                  place.cache_slice(cache and cache["moe"]))
    elif cfg.family in ("dense", "vlm"):
        add_layer("decoder_layer", cfg.n_layers,
                  place.layer(params["blocks"], "blocks"), attn_fwd,
                  attn_decode, place.cache_slice(cache and cache["self"]))
    else:
        add_layer("mamba_layer", cfg.n_layers,
                  place.layer(params["blocks"], "blocks"), mamba_fwd,
                  mamba_decode, place.cache_slice(cache and cache["mamba"]))
        if cfg.family == "hybrid":
            add_layer("shared_attn", cfg.n_layers // cfg.hybrid.attn_every,
                      place.layer(params["shared_attn"][0], "shared",
                                  drop_stack=False),
                      attn_fwd, attn_decode,
                      place.cache_slice(cache and cache["attn"]))

    # ------------------------------------------------------------- tail
    embed_p = place.layer({k: params[k] for k in ("embed", "final_norm",
                                                  "lm_head") if k in params},
                          "", drop_stack=False)
    if mode == "train":
        # the CE head unchunked over the microbatch: the FLOPs and logits
        # traffic of the chunked head, its weight gradient formed once
        ce_tokens = batch * max(q_len - 1, 1)
        with FakeTensorMode():
            hc = place.replicated(torch.empty((ce_tokens, d), dtype=dtype))
            tc = place.replicated(torch.empty((ce_tokens,),
                                              dtype=torch.int64))
            tokens = place.replicated(torch.empty((batch, q_len),
                                                  dtype=torch.int64))
            opt_state = adamw.init(adamw.AdamWConfig(), params)
        full_params = params
        if mesh is not None:
            psh = S.params_shardings(mesh, plan, params)
            full_params = S.place_tree(params, psh)
            opt_state = S.place_tree(opt_state, S.opt_state_shardings(
                mesh, plan, psh, opt_state))

        def ce(ep, hc, tc):
            # whole over the vocab first, as transformer._chunked_ce
            logits = replicate_dims(T._head(cfg, ep, hc[None])[0], [-1])
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, tc[:, None])[:, 0]
            return (logz - ll).sum()

        cost("ce_head", micro,
             _grads_of(ce, lambda a: tree_leaves(a[0]) + [a[1]]),
             (embed_p, hc, tc))
        cost("embed", micro,
             _grads_of(lambda ep, t: ep["embed"][t].sum(),
                       lambda a: [a[0]["embed"]]),
             (embed_p, tokens))
        ocfg = adamw.AdamWConfig()
        cost("optimizer", 1,
             lambda p, o, g: adamw.apply(ocfg, o, g, p)[:2],
             (full_params, opt_state, full_params))
        if mesh is not None:
            _grad_reduce(mesh, plan, params, cost)
    else:
        last = mode == "prefill"
        cost("lm_head", 1,
             lambda ep, h: T._head(cfg, ep, h[:, -1:] if last else h),
             (embed_p, x))
    return comps


def _grad_reduce(mesh, plan: ShardingPlan, params: Any,
                 cost: Callable) -> None:
    """The reference's ``grad_reduce``: one all-reduce of every gradient's
    local shard (the parameters' shardings, in ``plan.grad_reduce_dtype``)
    over the dp axes, when they hold more than one device and there is no
    fsdp (which reduce-scatters inside its layers instead)."""
    dp_axes = tuple(a for a in plan.batch_axes if a in S.mesh_axes(mesh))
    if S._axis_size(mesh, dp_axes) <= 1 or plan.fsdp_axes:
        return
    import torch.distributed._functional_collectives as funcol

    live = [a for a in dp_axes if S.mesh_axes(mesh)[a] > 1]
    sub = mesh[tuple(live)] if len(live) > 1 else mesh[live[0]]
    group = sub._flatten() if len(live) > 1 else sub
    gd = T.torch_dtype(plan.grad_reduce_dtype)
    psh = S.params_shardings(mesh, plan, params)
    coord = mesh.get_coordinate()
    with FakeTensorMode():
        grads = tree_map(lambda p, s: torch.empty(
            [sl.stop - sl.start for sl in S.local_slices(
                p.shape, mesh, s.placements, coord)], dtype=gd), params, psh)

    def reduce(g):
        return tree_map(lambda t: funcol.all_reduce(t, "sum", group), g)
    cost("grad_reduce", 1, reduce, (grads,))


def _enc_dec_layers(cfg: ArchConfig, params, cache, x: torch.Tensor,
                    mode: str, plan: ShardingPlan, micro: int, kv_len: int,
                    cost: Callable, place: _Placer) -> None:
    """The encoder-decoder's layer components (the reference's branch):
    ``encoder_layer`` at prefill and train over the ``encoder_seq`` frames,
    non-causal; ``decoder_layer`` with its cross K/V computed from the
    encoder's output inside it (train: its backward without remat, the
    gradients of the weights and of x, as the reference's), or at decode
    read from the cache beside the self cache's slice."""
    batch, d = x.shape[0], cfg.d_model
    enc_len = cfg.enc_dec.encoder_seq
    with FakeTensorMode():
        enc_x = place.replicated(torch.empty((batch, enc_len, d),
                                             dtype=x.dtype))
    enc0 = place.layer(params["enc_blocks"], "enc_blocks")
    dec0 = place.layer(params["blocks"], "blocks")

    def enc_fwd(p, h):
        pos = T._positions(h.shape[0], h.shape[1], h.device)
        return T.block_apply(cfg, p, h, positions=pos, window=None,
                             causal=False)[0]
    if mode != "decode":
        fn = _train_wrap(enc_fwd, plan.remat) if mode == "train" else enc_fwd
        cost("encoder_layer", cfg.enc_dec.n_encoder_layers * micro, fn,
             (enc0, enc_x))
    if mode == "decode":
        def dec_decode(p, h, c, ck, cv):
            pos = torch.full((h.shape[0], 1), kv_len - 1, dtype=torch.int32)
            out, c2, _ = T.block_apply(cfg, p, h, positions=pos, window=None,
                                       kv_cache=c, cross_state=(ck, cv),
                                       pos=kv_len - 1)
            return out, c2
        ck = T._layer(cache["cross_k"], 0)
        if place.mesh is not None:          # [B, Hkv, F, hd]: heads over tp
            ck = place.replicated(ck, None, _guarded(
                place.mesh, ck.shape[1], plan.tp_axes), None, None)
        cost("decoder_layer", cfg.n_layers * micro, dec_decode,
             (dec0, x, place.cache_slice(cache["self"]), ck, ck))
        return

    def dec_fwd(p, h, e):
        pos = T._positions(h.shape[0], h.shape[1], h.device)
        ck, cv = T.cross_kv(cfg, p["cross"], e)
        return T.block_apply(cfg, p, h, positions=pos, window=None,
                             cross_state=(ck, cv))[0]
    fn = dec_fwd
    if mode == "train":
        fn = _grads_of(lambda p, h, e: dec_fwd(p, h, e).sum(),
                       lambda a: tree_leaves(a[0]) + [a[1]])
    cost("decoder_layer", cfg.n_layers * micro, fn, (dec0, x, enc_x))


def aggregate(comps: List[Component], cc: ClusterConfig) -> Dict[str, Any]:
    """Eq (1): weighted sum of component costs -> step roofline terms."""
    flops = bytes_ = coll_bytes = 0.0
    coll_time = 0.0
    per = []
    for c in comps:
        r = c.cost.roofline(cc)
        flops += c.count * c.cost.flops_per_device
        bytes_ += c.count * c.cost.bytes_per_device
        coll_bytes += c.count * c.cost.collective_bytes
        coll_time += c.count * r["collective_s"]
        per.append({"name": c.name, "count": c.count,
                    "flops_per_device": c.cost.flops_per_device,
                    "bytes_per_device": c.cost.bytes_per_device,
                    "collective_bytes": c.cost.collective_bytes,
                    "collectives": c.cost.collective_bytes_by_kind()})
    compute_s = flops / cc.chip.peak("bfloat16")
    memory_s = bytes_ / cc.chip.hbm_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_time}
    dominant = max(terms, key=terms.get)
    return {
        **terms,
        "dominant": dominant,
        "roofline_bound_s": max(terms.values()),
        "flops_per_device": flops,
        "bytes_per_device": bytes_,
        "collective_bytes_per_device": coll_bytes,
        "components": per,
    }
