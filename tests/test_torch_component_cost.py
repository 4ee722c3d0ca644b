"""``repro_torch.launch.component_cost`` against the reference's
``launch/component_cost.py`` on a one-device CPU mesh: ``.reduced()`` fp32
qwen1.5-0.5b, mamba2-1.3b, zamba2-2.7b, qwen1.5-4b, stablelm-12b,
qwen1.5-110b, pixtral-12b (vlm: the dense components over ``seq_len``
positions, the patches not counted, as in the reference), whisper-small
(encoder-decoder: ``encoder_layer`` at prefill and train, ``decoder_layer``
with its cross K/V) and gemma3-12b (window pattern ``(8, None)``:
``layer_w8`` and ``layer_wglobal``, decode with each one's ring cache) and
phi3.5-moe-42b-a6.6b (``moe_layer``: 4 experts, top-2, the dense fp32
dispatch and combine products) and deepseek-v3-671b (``dense_layer`` and
``moe_layer`` with MLA, the shared expert, decode with the ``ckv`` /
``krope`` cache slices; MLA's ranks at full size) at
B 2 x S 64, in prefill, decode and train (train under
remat ``none`` and ``full``).

Names and counts are the reference's.  FLOPs agree within
:data:`FLOP_BAND` of the reference's, not exactly: the port counts one
FLOP per element of each eager op, XLA counts its own decomposition of the
same work (transcendentals kept apart, a reduction by its input, fused
forms of softmax and norms).  The port's counts sit at 0.81-1.00 x the
reference's here (mamba2's layer lowest), inside the band below with
room.  A product's FLOPs agree exactly (``tests/test_torch_graph_cost.py``),
and so does the matmul work of the components against the whole prefill."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.core.planner import ShardingPlan as RefShardingPlan
from repro.launch.component_cost import component_costs as ref_component_costs
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ShardingPlan, h100_single_config
from repro_torch.core import graph_cost
from repro_torch.launch.component_cost import aggregate, component_costs
from repro_torch.models.model import build_model

# the dense archs qwen1.5-4b, stablelm-12b and qwen1.5-110b take the dense
# family's components as they are: no change was needed for them
ARCHS = ("qwen1.5-0.5b", "mamba2-1.3b", "zamba2-2.7b", "qwen1.5-4b",
         "stablelm-12b", "qwen1.5-110b", "pixtral-12b", "whisper-small",
         "gemma3-12b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")
BATCH, SEQ = 2, 64
FLOP_BAND = (0.75, 1.25)


def reduced_fp32(get, arch):
    return dataclasses.replace(get(arch).reduced(), dtype="float32")


def ref_components(arch, mode, remat):
    mesh = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    return ref_component_costs(reduced_fp32(ref_get_config, arch),
                               RefShapeConfig("s", SEQ, BATCH, mode),
                               RefShardingPlan(remat=remat), mesh)


def port_components(arch, mode, remat):
    return component_costs(reduced_fp32(get_config, arch),
                           ShapeConfig("s", SEQ, BATCH, mode),
                           ShardingPlan(remat=remat))


@pytest.mark.parametrize("mode,remat", [("prefill", "none"),
                                        ("decode", "none"),
                                        ("train", "none"), ("train", "full")])
@pytest.mark.parametrize("arch", ARCHS)
def test_components_match_the_reference(arch, mode, remat):
    ref = ref_components(arch, mode, remat)
    got = port_components(arch, mode, remat)
    assert [(c.name, c.count) for c in got] == [(c.name, c.count)
                                                for c in ref]
    d = 64                                        # the reduced d_model
    for mine, theirs in zip(got, ref):
        flops, ref_flops = (mine.cost.flops_per_device,
                            theirs.cost.flops_per_device)
        if mine.name == "embed":
            # the sum's inputs and the gradient's scatter-add, one FLOP a
            # value each; jnp.take also selects over every gathered element
            # (its fill mode), so the reference counts about a third more
            tokens = BATCH * SEQ
            assert flops == 2 * tokens * d
            ratio = 3 * tokens * d / ref_flops
        elif mine.name == "lm_head" and mode == "prefill":
            # both packages' prefill heads the last position only; the
            # reference's component heads every position
            ratio = flops * SEQ / ref_flops
        else:
            ratio = flops / ref_flops
        assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], (mine.name, ratio)
        assert mine.cost.unknown_dtypes == [] and mine.cost.collectives == []
    agg = aggregate(got, h100_single_config())
    assert agg["flops_per_device"] == sum(c.count * c.cost.flops_per_device
                                          for c in got)
    assert [c["name"] for c in agg["components"]] == [c.name for c in got]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_components_sum_to_the_whole_program(arch, monkeypatch):
    """Counted as matmul-family FLOPs only (the elementwise rule switched
    off), the prefill components times their counts equal one trace of the
    port's whole ``prefill``: no layer or head is left out or doubled.
    whisper's prefill runs the encoder over ``encoder_seq`` frames; pixtral's
    runs without patches, which its components do not count."""
    monkeypatch.setattr(graph_cost, "_elementwise_flops",
                        lambda *args: 0)
    comps = port_components(arch, "prefill", "none")
    cfg = reduced_fp32(get_config, arch)
    model = build_model(cfg, device="cpu")
    with FakeTensorMode():
        params = model.init(0)
        cache = model.init_cache(BATCH, SEQ)
        tokens = torch.empty((BATCH, SEQ), dtype=torch.int64)
        frames = (torch.empty((BATCH, cfg.enc_dec.encoder_seq, cfg.d_model))
                  if cfg.enc_dec else None)
    _, whole = graph_cost.lower_and_cost(
        "prefill", lambda p, t, c, f: model.prefill(p, t, c, f),
        (params, tokens, cache, frames))
    assert whole.flops_per_device == sum(c.count * c.cost.flops_per_device
                                         for c in comps) > 0


def test_more_than_one_device_raises():
    cfg = reduced_fp32(get_config, "qwen1.5-0.5b")
    with pytest.raises(TypeError, match="needs a DeviceMesh"):
        component_costs(cfg, ShapeConfig("s", SEQ, BATCH, "train"),
                        ShardingPlan(), mesh=[torch.device("cpu")] * 2)


def test_microbatches_multiply_the_layer_counts():
    cfg = reduced_fp32(get_config, "zamba2-2.7b")
    comps = component_costs(cfg, ShapeConfig("s", SEQ, 4, "train"),
                            ShardingPlan(microbatches=2))
    counts = {c.name: c.count for c in comps}
    assert counts == {"mamba_layer": 2 * cfg.n_layers,
                      "shared_attn": 2 * cfg.n_layers
                      // cfg.hybrid.attn_every,
                      "ce_head": 2, "embed": 2, "optimizer": 1}
