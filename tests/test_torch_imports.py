"""The port stands alone: it imports neither jax nor the reference package,
registers only what is ported, and its entry points refuse to run without a
GPU unless the caller asks for the CPU."""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

MODULES = [
    "repro_torch", "repro_torch.configs", "repro_torch.convert",
    "repro_torch.kernels.ops", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.tsmm", "repro_torch.kernels._build",
    "repro_torch.kernels.ssd_scan", "repro_torch.kernels.matmul_epilogue",
    "repro_torch.configs.zamba2_2p7b", "repro_torch.models.mamba",
    "repro_torch.models.layers", "repro_torch.models.transformer",
    "repro_torch.models.model", "repro_torch.runtime.serve_engine",
    "repro_torch.launch.serve", "repro_torch.examples.linreg_ds",
    "repro_torch.benchmarks.bench_accuracy",
    "repro_torch.benchmarks.bench_calibrate",
    "repro_torch.benchmarks.bench_fusion",
    "repro_torch.launch.component_cost",
    "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.compress", "repro_torch.runtime.train_loop",
    "repro_torch.configs.deepseek_v3", "repro_torch.data",
    "repro_torch.data.pipeline", "repro_torch.checkpoint",
    "repro_torch.checkpoint.store", "chip_smoke",
    "repro_torch.runtime.straggler", "repro_torch.runtime.elastic",
    "repro_torch.launch.train", "repro_torch.examples.train_lm",
    "repro_torch.examples.serve_lm", "repro_torch.launch.mesh",
    "repro_torch.launch.shardings", "repro_torch.launch.dryrun",
    "repro_torch.benchmarks.bench_roofline", "repro_torch.models.sharded",
] + [f"repro_torch.core.{m}" for m in (
    "npvec", "calibration", "cluster", "symbols", "plan", "linalg_ops",
    "hlo_cost", "costmodel", "explain", "linreg", "dominance", "planner",
    "workload", "resource", "serving", "sweep", "parallel",
    "graph_cost")] + [
    "repro_torch.core"]


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_no_jax_and_no_reference(module):
    code = (
        "import sys, importlib\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
        "or m.split('.')[0] == 'ml_dtypes')\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'a process group'\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_h100_node_presets():
    """One node: (1, 8) on NVLink; two: (2, 1, 8), the pod axis on the
    network at a DGX H100's 8 x 400 Gb/s; neither in the sweep tables."""
    from repro_torch.core import cluster, sweep
    node, multi = cluster.h100_node_config(), cluster.h100_multi_node_config()
    assert (node.mesh_shape, node.mesh_axes) == ((1, 8), ("data", "model"))
    assert node.chip == cluster.H100_SXM
    assert (multi.mesh_shape, multi.mesh_axes) == ((2, 1, 8),
                                                   ("pod", "data", "model"))
    assert multi.chip.dcn_bw == 400e9 and multi.chip.name == "h100_sxm"
    assert multi.link_class("pod") == "dcn"
    assert multi.link_class("model") == node.link_class("model") == "ici"
    assert multi.link_bw("model") == node.link_bw("model")
    assert all(cc.chip.name != "h100_sxm"
               for cc in sweep.CLUSTERS.values())


@pytest.mark.parametrize("module", ["repro_torch.core",
                                    "repro_torch.core.parallel",
                                    "repro_torch.core.graph_cost"])
def test_cost_model_loads_no_torch(module):
    """The cost model is numpy and the standard library: ``parallel``'s spawn
    workers import it, and must never load torch or initialise CUDA."""
    code = (
        "import sys, importlib\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'repro'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["repro_torch.runtime.straggler",
                                    "repro_torch.runtime.elastic"])
def test_array_free_runtime_loads_no_torch(module):
    """The straggler monitor and the elastic replan are numpy and the cost
    model; ``elastic.reshard`` imports torch only when it is called."""
    code = (
        "import sys, importlib\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'repro'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_chip_tables_equal_the_reference_and_leave_out_the_h100():
    from repro.core import cluster as ref_cluster
    from repro.core import sweep as ref_sweep
    from repro_torch.core import cluster, sweep
    assert list(cluster.CHIPS) == list(ref_cluster.CHIPS)
    assert list(sweep.CLUSTERS) == list(ref_sweep.CLUSTERS)
    assert cluster.H100_SXM not in cluster.CHIPS.values()
    assert all(cc.chip.name != "h100_sxm" for cc in sweep.CLUSTERS.values())
    assert "h100_sxm" not in cluster.CHIPS


def test_h100_preset_carries_the_datasheet_constants():
    from repro_torch.core import ClusterConfig, H100_SXM, h100_single_config
    from repro_torch.core.linreg import (Scenario, build_linreg_program,
                                         tpu_budgets)
    assert H100_SXM.peak_flops == {
        "bfloat16": 989e12, "float16": 989e12, "int8": 1979e12,
        "float8": 1979e12, "float32": 67e12, "float64": 67e12}
    assert (H100_SXM.hbm_bytes, H100_SXM.hbm_bw) == (80e9, 3.35e12)
    assert (H100_SXM.ici_bw_per_link, H100_SXM.ici_domain) == (450e9, 8)
    assert H100_SXM.pcie_bw == 64e9
    assert H100_SXM.vmem_bytes == 50 * 2 ** 20
    assert H100_SXM.cost_per_chip_hour == 0.0
    cc = h100_single_config()
    assert (cc.chip, cc.mesh_shape, cc.mesh_axes) == (H100_SXM, (1,),
                                                      ("data",))
    # every other field keeps the reference default: nothing fitted
    default = ClusterConfig()
    assert all(getattr(cc, f.name) == getattr(default, f.name)
               for f in dataclasses.fields(ClusterConfig)
               if f.name not in ("chip", "mesh_shape", "mesh_axes"))
    _, choice = build_linreg_program(
        Scenario("h100-linreg", 262144, 1024, dtype="float32"), cc,
        tpu_budgets(cc))
    assert (choice.exec_type, choice.tsmm_op) == ("CP", "tsmm")


def test_sources_name_neither_jax_nor_the_reference_package():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import repro\b|from repro\b|from repro\.)",
        re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    hits = [str(f) for f in files if pattern.search(f.read_text())]
    assert not hits, hits


def test_csrc_sources_have_a_plain_c_interface():
    for name in ("flash_attention", "flash_attention_bwd", "tsmm",
                 "ssd_scan", "ssd_scan_bwd", "matmul_epilogue"):
        text = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
        assert 'extern "C"' in text and "torch/extension.h" not in text
        assert "cudaGetLastError" in text


def test_build_lists_every_source():
    """``chip_smoke.py`` builds ``_build.SOURCES``: every ``csrc/*.cu``,
    the backward kernels included, and nothing is built at import."""
    from repro_torch.kernels import _build
    on_disk = sorted(p.stem for p in (PORT / "kernels" / "csrc").glob("*.cu"))
    assert sorted(_build.SOURCES) == on_disk
    assert {"flash_attention_bwd", "ssd_scan_bwd"} <= set(_build.SOURCES)
    assert not _build._libs


def _needs_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal cannot be shown")


def test_build_model_raises_without_cuda():
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfgs = [get_config("qwen1.5-0.5b").reduced(), get_config("mamba2-1.3b"),
            get_config("zamba2-2.7b")]
    for cfg in cfgs:
        assert build_model(cfg, device="cpu").device.type == "cpu"
    _needs_no_gpu()
    for cfg in cfgs:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg)


def test_launcher_and_example_raise_without_cuda():
    from repro_torch.examples import linreg_ds
    from repro_torch.launch import serve
    _needs_no_gpu()
    for arch in ("qwen1.5-0.5b", "mamba2-1.3b", "zamba2-2.7b"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--arch", arch, "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        linreg_ds.execute_small(256, 64)


# the train driver at a CPU size: the reduced model, B 4 x S 32
TRAIN_CPU = ["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "3",
             "--global-batch", "4", "--seq-len", "32"]


def test_trainer_driver_and_examples_raise_without_cuda(tmp_path):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import h100_single_config
    from repro_torch.examples import serve_lm, train_lm
    from repro_torch.launch import train
    from repro_torch.runtime.train_loop import Trainer
    _needs_no_gpu()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(TRAIN_CPU)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(["--steps", "3", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_lm.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(get_config("qwen1.5-0.5b").reduced(), SHAPES["train_4k"],
                h100_single_config())
    assert not list(tmp_path.iterdir())


def test_trainer_driver_runs_on_the_cpu_when_asked(capsys):
    """The ranking (costed for the CPU host), then three logged steps,
    each a JSON line with a finite loss."""
    import json
    import math
    from repro_torch.launch import train
    train.main(TRAIN_CPU + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "== cost-based plan ranking (cpu_host) ==" in out
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert all(math.isfinite(r["loss"]) for r in rows)
    assert "kernels off" in out


def test_trainer_driver_explains_without_a_device(capsys):
    """``--explain`` costs the winner for the card and prints EXPLAIN; it
    runs nothing, so it needs no card."""
    from repro_torch.launch import train
    train.main(["--arch", "qwen1.5-0.5b", "--global-batch", "8",
                "--seq-len", "2048", "--explain"])
    out = capsys.readouterr().out
    assert "(h100_sxm)" in out and "dp+tp[batch=data,remat=none]" in out
    assert "PROGRAM" in out


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_trainer_driver_refuses_a_mesh(mesh, monkeypatch):
    """A production mesh runs under torchrun on GPUs: on the CPU, outside
    torchrun, or in a world of another size than the mesh's, the driver
    refuses it before it initialises anything."""
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="--device cpu runs --mesh host"):
        train.main(TRAIN_CPU + ["--device", "cpu", "--mesh", mesh])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="runs under torchrun"):
        train.main(TRAIN_CPU + ["--mesh", mesh])
    monkeypatch.setenv("WORLD_SIZE", "3")
    need = 8 if mesh == "single" else 16
    with pytest.raises(ValueError, match=f"{need} GPUs; torchrun started 3"):
        train.main(TRAIN_CPU + ["--mesh", mesh])


def test_examples_run_on_the_cpu_when_asked(capsys, tmp_path):
    """``train_lm`` trains the reduced model 3 steps and checkpoints
    nothing before step 100; ``serve_lm`` keeps its determinism assert and
    its 2-slot continuous pool."""
    from repro_torch.examples import serve_lm, train_lm
    train_lm.main(["--device", "cpu", "--steps", "3", "--ckpt-dir",
                   str(tmp_path)])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "straggler verdict: none" in out
    serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "determinism check passed" in out
    assert "continuous, slots=2: 2 admission rounds" in out
    assert "kernels off" in out


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
                "--batch", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "req1:" in out and "kernels off" in out


def test_launcher_serves_mamba_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "40", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "req1:" in out and "kernels off" in out


def test_launcher_serves_phi_moe_on_the_cpu_when_asked(capsys):
    """The moe arch through the launcher, at one layer (``--layers``);
    an arch id the reference does not know is refused by ``--arch``."""
    from repro_torch.launch import serve
    serve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--reduced", "--layers",
                "1", "--device", "cpu", "--batch", "2", "--prompt-len", "20",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "req1:" in out and "kernels off" in out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "deepseek-v2", "--reduced", "--device", "cpu"])


def test_launcher_serves_deepseek_on_the_cpu_when_asked(capsys):
    """The MLA arch through the launcher, reduced, at 2 layers (one dense,
    one moe): prefill, then the absorbed decode."""
    from repro_torch.launch import serve
    serve.main(["--arch", "deepseek-v3-671b", "--reduced", "--layers", "2",
                "--device", "cpu", "--batch", "2", "--prompt-len", "12",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "req1:" in out and "kernels off" in out


def test_launcher_serves_zamba2_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "20", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "req1:" in out and "kernels off" in out


def test_chip_smoke_fails_without_cuda():
    _needs_no_gpu()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_only_ported_archs_are_registered():
    from repro_torch import configs
    assert configs.PORTED_ARCH_IDS == ["qwen1.5-0.5b", "mamba2-1.3b",
                                       "zamba2-2.7b", "qwen1.5-4b",
                                       "stablelm-12b", "qwen1.5-110b",
                                       "pixtral-12b", "whisper-small",
                                       "gemma3-12b", "phi3.5-moe-42b-a6.6b",
                                       "deepseek-v3-671b"]
    assert sorted(configs.PORTED_ARCH_IDS) == sorted(configs.ARCH_IDS)
    cfg = configs.get_config("qwen1.5-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size, cfg.qkv_bias) == (24, 1024, 16, 2816, 151936, True)
    cfg = configs.get_config("mamba2-1.3b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.vocab_size,
            cfg.ssm.state_size, cfg.ssm.chunk_size) == (
                "ssm", 48, 2048, 50280, 128, 256)
    cfg = configs.get_config("zamba2-2.7b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.head_dim_,
            cfg.hybrid.attn_every, cfg.hybrid.n_shared_attn_blocks) == (
                "hybrid", 54, 2560, 80, 6, 2)
    for arch, dims in (("qwen1.5-4b", (40, 2560, 20, 20, 128, 6912)),
                       ("stablelm-12b", (40, 5120, 32, 8, 160, 13824)),
                       ("qwen1.5-110b", (80, 8192, 64, 8, 128, 49152))):
        cfg = configs.get_config(arch)
        assert cfg.family == "dense"
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.head_dim_, cfg.d_ff) == dims
    cfg = configs.get_config("pixtral-12b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff, cfg.vocab_size,
            cfg.frontend, cfg.frontend_seq) == (
                "vlm", 40, 5120, 32, 8, 128, 14336, 131072, "vision_stub",
                1024)
    cfg = configs.get_config("whisper-small")
    assert (cfg.family, cfg.n_layers, cfg.enc_dec.n_encoder_layers,
            cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.d_ff,
            cfg.vocab_size, cfg.gated_mlp, cfg.qkv_bias,
            cfg.enc_dec.encoder_seq) == (
                "audio", 12, 12, 768, 12, 64, 3072, 51865, False, True, 1500)
    cfg = configs.get_config("gemma3-12b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff, cfg.vocab_size,
            cfg.tie_embeddings, cfg.window_pattern, cfg.local_window) == (
                "dense", 48, 3840, 16, 8, 256, 15360, 262144, False,
                (1024,) * 5 + (None,), 1024)
    cfg = configs.get_config("phi3.5-moe-42b-a6.6b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim_, cfg.vocab_size, cfg.moe.n_experts,
            cfg.moe.top_k, cfg.moe.d_ff_expert, cfg.moe.capacity_factor,
            cfg.moe.first_dense_layers, cfg.mla) == (
                "moe", 32, 4096, 32, 8, 128, 32064, 16, 2, 6400, 1.25, 0,
                None)
    cfg = configs.get_config("deepseek-v3-671b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.vocab_size, cfg.moe.n_experts, cfg.moe.top_k,
            cfg.moe.d_ff_expert, cfg.moe.n_shared_experts,
            cfg.moe.first_dense_layers, cfg.moe.d_ff_dense,
            cfg.mla.q_lora_rank, cfg.mla.kv_lora_rank, cfg.mla.qk_head_dim,
            cfg.mla.v_head_dim, cfg.mtp_depth) == (
                "moe", 61, 7168, 128, 129280, 256, 8, 2048, 1, 3, 18432,
                1536, 512, 192, 128, 1)
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("arch_id", ["deepseek-v3-671b"])
def test_unported_arch_raises_not_implemented(arch_id):
    """The last arch to be registered resolves now; what the port still
    refuses is MLA outside the moe family (the reference has no decode for
    it: its dense stack reads a cache group its ``init_cache`` does not
    make)."""
    from repro_torch import configs
    from repro_torch.models.model import build_model
    cfg = configs.get_config(arch_id)
    assert cfg.mla is not None and cfg.family == "moe"
    assert build_model(cfg.reduced(), device="cpu").cfg.mla == cfg.mla
    dense_mla = dataclasses.replace(
        configs.get_config("qwen1.5-0.5b").reduced(), mla=cfg.mla)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(dense_mla, device="cpu")


@pytest.mark.parametrize("arch_id", [
    "whisper-small", "pixtral-12b", "zamba2-2.7b", "phi3.5-moe-42b-a6.6b",
    "deepseek-v3-671b", "stablelm-12b", "qwen1.5-4b", "qwen1.5-110b",
    "gemma3-12b", "qwen1.5-0.5b", "mamba2-1.3b"])
def test_every_arch_id_resolves(arch_id):
    """Every arch of the reference resolves to a config whose reduced form
    builds a model on the CPU."""
    from repro_torch import configs
    from repro_torch.models.model import build_model
    assert arch_id in configs.ARCH_IDS
    cfg = configs.get_config(arch_id)
    assert cfg.name == arch_id
    assert build_model(cfg.reduced(), device="cpu").cfg.name == arch_id


@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "mamba2-1.3b",
                                     "zamba2-2.7b", "qwen1.5-4b",
                                     "stablelm-12b", "qwen1.5-110b",
                                     "pixtral-12b", "whisper-small",
                                     "gemma3-12b", "phi3.5-moe-42b-a6.6b",
                                     "deepseek-v3-671b"])
def test_config_copy_equals_the_reference(arch_id):
    """The port keeps its own copy of the config schema; it must not drift."""
    from repro.configs import ARCH_IDS, get_config as ref_get
    from repro_torch import configs
    assert configs.ARCH_IDS == ARCH_IDS
    ref, mine = ref_get(arch_id), configs.get_config(arch_id)
    assert dataclasses.asdict(ref) == dataclasses.asdict(mine)
    assert dataclasses.asdict(ref.reduced()) == dataclasses.asdict(
        mine.reduced())
    assert ref.n_params == mine.n_params


def test_non_dense_family_raises_in_the_model():
    """A family still unported (multi-head latent attention without
    experts) raises, and so does a hybrid config without its HybridConfig
    and a dense config that holds experts; the ssm, hybrid and moe families
    build (the moe family with GQA and with MLA, as deepseek-v3 has it),
    and so does the dense family with a window pattern."""
    from repro_torch.configs import MLAConfig, MoEConfig, get_config
    from repro_torch.models.model import build_model
    ssm = get_config("mamba2-1.3b").reduced()
    assert build_model(ssm, device="cpu").cfg is ssm
    hybrid = get_config("zamba2-2.7b").reduced()
    assert build_model(hybrid, device="cpu").cfg is hybrid
    dense = get_config("qwen1.5-0.5b").reduced()
    moe = dataclasses.replace(dense, family="moe", moe=MoEConfig(4, 2, 64))
    assert build_model(moe, device="cpu").cfg is moe
    mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                    qk_rope_head_dim=8, v_head_dim=16)
    moe_mla = dataclasses.replace(moe, mla=mla)
    assert build_model(moe_mla, device="cpu").cfg is moe_mla
    for cfg in (dataclasses.replace(dense, moe=MoEConfig(4, 2, 64)),
                dataclasses.replace(dense, mla=mla),
                dataclasses.replace(ssm, family="hybrid")):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            build_model(cfg, device="cpu")
    windowed = dataclasses.replace(dense, window_pattern=(8, None))
    assert build_model(windowed, device="cpu").cfg is windowed
