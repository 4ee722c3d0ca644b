"""``chip_smoke.expected_train_launches`` and ``expected_launches``, the
counts the train and serve phases hold the card's launches to, against the
calls the port's kernel path makes on the CPU.  On CPU tensors every kernel wrapper takes its plain version (and
counts nothing), so each plain version that stands in for a launch is
counted here instead: the forward and backward of flash attention, of
the SSD scan and of the causal conv, and the matmul epilogue's forward and
its backward's recompute of z.  zamba2 is the train path this count was not yet held to
(its shared blocks applied ``n_layers // attn_every`` times, each under
remat ``full``); qwen and mamba2 are held to it beside it, and so are the
dense archs qwen1.5-4b, stablelm-12b and qwen1.5-110b at the depth each
path runs on the card (``chip_smoke.path_config``; reduced in width here),
with GQA kept (4 heads over 2 kv heads), and so are the frontend archs
pixtral-12b (patches prepended) and whisper-small (a non-causal encoder
and a decoder with cross-attention, which takes no kernel), each with its
frontend embeddings, and so is gemma3-12b (its window pattern reduced to
``(8, None)``), whose flash launches are also held by window, as every
arch's are, and so is phi3.5-moe-42b-a6.6b (4 heads over 2 kv heads, 4
experts), whose routed experts take no kernel: its epilogue launches are
the heads' alone, and so is deepseek-v3-671b (MLA, so no flash launch at
all; its dense layers' and shared experts' gates and, in training, the
MTP head's CE chunks on the epilogue kernel, the MTP block's gate plain).  The serve count is held over a ``generate`` of static
and of continuous batching (static only with a frontend, which is
single-admission), and so is the Mamba2 archs' (the causal conv launches
in every decode step too)."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (DEPTH_CUTS, depth_cut,  # noqa: E402
                        expected_flash_windows, expected_launches,
                        expected_train_launches, parity_config, path_batch,
                        path_config)
from repro_torch.runtime.serve_engine import (EngineConfig,  # noqa: E402
                                              Request, ServeEngine)
from repro_torch.configs import get_config                     # noqa: E402
from repro_torch.core import ShardingPlan                      # noqa: E402
from repro_torch.kernels import causal_conv as cc              # noqa: E402
from repro_torch.kernels import flash_attention as fa          # noqa: E402
from repro_torch.kernels import matmul_epilogue as mme         # noqa: E402
from repro_torch.kernels import ssd_scan as ssd                # noqa: E402
from repro_torch.models.model import build_model               # noqa: E402
from repro_torch.optim import adamw                            # noqa: E402
from repro_torch.runtime.train_loop import make_train_step     # noqa: E402

BATCH, SEQ, STEPS = 2, 64, 2
# (module, plain version standing in for a launch, the kernel it counts as)
STAND_INS = [(fa, "flash_attention_plain", "flash_attention"),
             (fa, "flash_attention_bwd_plain", "flash_attention_bwd"),
             (ssd, "ssd_scan_plain", "ssd_scan"),
             (ssd, "ssd_scan_bwd_plain", "ssd_scan_bwd"),
             (mme, "matmul_epilogue_plain", "matmul_epilogue"),
             (cc, "causal_conv_plain", "causal_conv"),
             (cc, "causal_conv_bwd_plain", "causal_conv_bwd")]


DENSE = ("qwen1.5-4b", "stablelm-12b", "qwen1.5-110b", "gemma3-12b",
         "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")
FRONTEND = ("pixtral-12b", "whisper-small")


def small(arch: str, phase: str):
    """The config ``phase`` runs on the card for ``arch``, reduced in
    width; the dense archs keep GQA (``.reduced()`` drops it)."""
    cfg = path_config(arch, phase)
    red = cfg.reduced()
    if arch in DENSE + FRONTEND:
        red = dataclasses.replace(red, n_heads=4, n_kv_heads=2)
    assert red.n_layers == min(cfg.n_layers, red.n_layers)
    return red


def count_stand_ins(monkeypatch, windows=None) -> dict:
    """Each plain version that stands in for a launch, counted; the flash
    ones also by window into ``windows`` (keyed as the wrappers count)."""
    calls = dict.fromkeys(("flash_attention", "flash_attention_bwd",
                           "tsmm_upper", "ssd_scan", "ssd_scan_bwd",
                           "matmul_epilogue", "causal_conv",
                           "causal_conv_bwd"), 0)

    def counted(fn, kernel):
        def wrapper(*args, **kwargs):
            calls[kernel] += 1
            if windows is not None and kernel.startswith("flash"):
                key = fa.window_key(kwargs.get("window"))
                counts = windows.setdefault(kernel, {})
                counts[key] = counts.get(key, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for module, name, kernel in STAND_INS:
        monkeypatch.setattr(module, name, counted(getattr(module, name),
                                                  kernel))
    return calls


def frontend(model, batch: int):
    """Random embeddings for an arch with a frontend, else None."""
    shape = model.frontend_shape(batch)
    if shape is None:
        return None
    return torch.randn(shape, generator=torch.Generator().manual_seed(2))


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-1.3b",
                                  "qwen1.5-0.5b", *DENSE, *FRONTEND])
def test_expected_train_launches_match_the_kernel_path(arch, remat,
                                                       monkeypatch):
    cfg = small(arch, "train")
    windows = {}
    calls = count_stand_ins(monkeypatch, windows)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    opt_cfg = adamw.AdamWConfig()
    step = make_train_step(model, opt_cfg, ShardingPlan(remat=remat),
                           use_kernel=True)
    opt = adamw.init(opt_cfg, params)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                                     generator=gen)}
    fe = frontend(model, BATCH)
    if fe is not None:
        batch["frontend"] = fe
    for _ in range(STEPS):
        params, opt, _, metrics = step(params, opt, None, batch)
        assert torch.isfinite(metrics["loss"])
    expected = expected_train_launches(cfg, remat, BATCH, SEQ, STEPS)
    assert calls == expected
    assert windows == {k: v for k, v in expected_flash_windows(
        cfg, expected).items() if v}
    if cfg.family == "hybrid":
        assert calls["flash_attention_bwd"] == (
            STEPS * cfg.n_layers // cfg.hybrid.attn_every) > 0


def test_parity_config_applies_every_shared_block_once():
    """The gradient parity of the train phase cuts depth; zamba2's cut
    applies each of its two shared blocks once (so the flash backward at
    D = 80 is held there), after one Mamba2 layer each; the others keep 2
    layers.  Width and every other field stay."""
    zamba = get_config("zamba2-2.7b")
    cut = parity_config(zamba, "bfloat16")
    assert (cut.n_layers, cut.hybrid.attn_every, cut.dtype) == (
        2, 1, "bfloat16")
    assert cut.n_layers // cut.hybrid.attn_every == (
        zamba.hybrid.n_shared_attn_blocks)
    assert dataclasses.replace(cut, n_layers=zamba.n_layers,
                               dtype=zamba.dtype,
                               hybrid=zamba.hybrid) == zamba
    for arch in ("qwen1.5-0.5b", "mamba2-1.3b"):
        cfg = get_config(arch)
        assert parity_config(cfg, "float32") == dataclasses.replace(
            cfg, n_layers=2, dtype="float32")


def test_deepseek_cuts_and_parity_config_keep_a_moe_layer():
    """deepseek-v3's train cut names its layers, its dense layers first,
    its routed experts and its batch; its parity cut keeps one dense layer
    and one moe layer of the train cut's experts (2 layers of the full
    config would be 2 of its 3 dense layers), from the full config and from
    the train cut alike.  Widths, heads, the MLA ranks and top-k stay."""
    full = get_config("deepseek-v3-671b")
    train = path_config("deepseek-v3-671b", "train")
    assert (train.n_layers, train.moe.first_dense_layers,
            train.moe.n_experts, train.moe.top_k) == (2, 1, 16, 8)
    assert path_batch("deepseek-v3-671b", "train") == 1
    assert path_batch("deepseek-v3-671b", "serve") == 8
    serve = path_config("deepseek-v3-671b", "serve")
    assert (serve.n_layers, serve.moe.first_dense_layers,
            serve.moe.n_experts) == (5, 3, 256)
    for cfg in (full, train):
        cut = parity_config(cfg, "float32")
        assert (cut.n_layers, cut.moe.first_dense_layers, cut.moe.n_experts,
                cut.dtype) == (2, 1, 16, "float32")
        assert dataclasses.replace(cut, n_layers=full.n_layers,
                                   dtype=full.dtype, moe=full.moe) == full
    line = depth_cut("deepseek-v3-671b", "train")
    assert (line["n_experts"], line["n_experts_full"], line["batch"],
            line["batch_full"], line["first_dense_layers_full"],
            line["n_layers_full"]) == (16, 256, 1, 8, 3, 61)
    assert list(line)[-1] == "reason"
    assert all(isinstance(cut["reason"], str) and cut["n_layers"] > 0
               for cut in DEPTH_CUTS.values())
    phi = get_config("phi3.5-moe-42b-a6.6b")
    assert parity_config(phi, "float32") == dataclasses.replace(
        phi, n_layers=2, dtype="float32")


@pytest.mark.parametrize("batching", ["static", "continuous"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", *DENSE, *FRONTEND])
def test_expected_launches_match_the_serve_path(arch, batching,
                                                monkeypatch):
    """A ``generate`` of 5 requests of the serve phase's kind on the
    kernel path: every admission round's flash and epilogue launches and
    every decode step's epilogue launches, as ``expected_launches`` counts
    them from the engine's rounds and steps.  With a frontend, which is
    single-admission, continuous batching runs with a slot a request (one
    round)."""
    cfg = small(arch, "serve")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    fe = frontend(model, 5)
    engine = ServeEngine(model, params, EngineConfig(
        max_len=48, batching=batching, slots=2 if fe is None else 5),
        use_kernel=True)
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(prompt=torch.randint(1, cfg.vocab_size, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=4) for n in (9, 16, 5, 12, 7)]
    windows = {}
    calls = count_stand_ins(monkeypatch, windows)
    outs = engine.generate(reqs, fe)
    assert all(len(o.tokens) == 4 for o in outs)
    rounds, steps = (engine.stats["admission_rounds"],
                     engine.stats["decode_steps"])
    assert rounds >= (2 if batching == "continuous" and fe is None else 1)
    expected = expected_launches(cfg, rounds, steps)
    assert calls == expected
    assert windows == {k: v for k, v in expected_flash_windows(
        cfg, expected).items() if v}
    enc = cfg.enc_dec.n_encoder_layers if cfg.enc_dec else 0
    if cfg.mla is not None:
        assert calls["flash_attention"] == 0 < calls["matmul_epilogue"]
    else:
        assert calls["flash_attention"] == (cfg.n_layers + enc) * rounds > 0


@pytest.mark.parametrize("batching", ["static", "continuous"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_expected_launches_match_the_mamba_serve_path(arch, batching,
                                                      monkeypatch):
    """The Mamba2 layers' serve path: the SSD scan once a layer each
    admission round (the one-token step is plain), the causal conv once a
    layer each round and each decode step, as ``expected_launches`` counts
    them; zamba2's shared blocks' flash and gates beside them."""
    cfg = small(arch, "serve")
    model = build_model(cfg, device="cpu")
    engine = ServeEngine(model, model.init(0), EngineConfig(
        max_len=48, batching=batching, slots=2), use_kernel=True)
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(prompt=torch.randint(1, cfg.vocab_size, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=4) for n in (9, 16, 5, 12, 7)]
    calls = count_stand_ins(monkeypatch)
    outs = engine.generate(reqs)
    assert all(len(o.tokens) == 4 for o in outs)
    rounds, steps = (engine.stats["admission_rounds"],
                     engine.stats["decode_steps"])
    assert calls == expected_launches(cfg, rounds, steps)
    assert calls["causal_conv"] == cfg.n_layers * (rounds + steps) > 0
    assert calls["ssd_scan"] == cfg.n_layers * rounds


def test_routing_recorder_reads_every_moe_layer():
    """``chip_smoke.RoutingRecorder`` keeps one (choices, drops) pair a moe
    layer of a forward, and ``routing_flips`` reads the share of choices
    and drops that two runs decide apart: none between the kernel path and
    the plain path on the CPU here (plain versions both, whose bf16
    roundings move no choice across a tie), all of them against a run
    whose choices are shifted by one expert.  The layers' routing is
    the same with and without the recorder.  A recorder that replays
    another run's choices routes every layer to them: the plain path
    replaying its own gives its logits again, the kernel path replaying
    shifted choices other logits, each layer's choices the shifted
    ones."""
    from chip_smoke import RoutingRecorder, drop_share, routing_flips
    cfg = small("phi3.5-moe-42b-a6.6b", "serve")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(3))
    recs = {}
    for use_kernel in (True, False):
        with RoutingRecorder() as recs[use_kernel]:
            logits, _ = model.forward(params, tokens, use_kernel=use_kernel,
                                      capacity_factor=0.5)
    plain, _ = model.forward(params, tokens, capacity_factor=0.5)
    torch.testing.assert_close(logits, plain, rtol=0, atol=0)
    assert len(recs[True].calls) == cfg.n_layers
    idx, keep = recs[True].calls[0]
    assert idx.shape == keep.shape == (1, 64, cfg.moe.top_k)
    flips = routing_flips(recs[True], recs[False])
    assert flips["choice_flip_share"] == flips["keep_flip_share"] == 0.0
    assert flips["calls"] == cfg.n_layers and flips["slots"] == (
        cfg.n_layers * 64 * cfg.moe.top_k)
    assert 0 < drop_share(recs[True].calls) == flips["drop_share"][1] < 1
    shifted = RoutingRecorder()
    shifted.calls = [((i + 1) % cfg.moe.n_experts, ~k)
                     for i, k in recs[False].calls]
    flips = routing_flips(recs[True], shifted)
    assert flips["choice_flip_share"] == flips["keep_flip_share"] == 1.0
    with RoutingRecorder(replay=recs[False].calls) as again:
        same, _ = model.forward(params, tokens, capacity_factor=0.5)
    torch.testing.assert_close(same, plain, rtol=0, atol=0)
    with RoutingRecorder(replay=shifted.calls) as forced:
        other, _ = model.forward(params, tokens, use_kernel=True,
                                 capacity_factor=0.5)
    assert not torch.allclose(other, plain)
    for (idx, _), (want, _) in zip(forced.calls, shifted.calls):
        assert torch.equal(idx, want)
    assert len(again.calls) == len(forced.calls) == cfg.n_layers
