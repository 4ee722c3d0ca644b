"""The run's own check that nothing of JAX, the JAX package, the smoke
script or the repo's tools was loaded compares whole top-level names; and a
whole run on the CPU loads none of them."""
import subprocess
import sys

from gpubench.lib import spec
from gpubench.lib.device import forbidden_loaded


def test_top_level_names_are_compared_whole():
    names = ["repro_torch", "repro_torch.models.model", "reproduce",
             "gpubench.lib.cli", "torch", "jaxtyping", "toolsx"]
    assert forbidden_loaded(names) == []
    bad = ["repro", "repro.core.costmodel", "jax", "jax.numpy", "jaxlib",
           "flax.linen", "chip_smoke", "tools.profile_train",
           "benchmarks.bench_accuracy"]
    assert forbidden_loaded(names + bad) == sorted(bad)


def test_a_run_loads_nothing_forbidden():
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(spec.ROOT)!r}, {str(spec.ROOT / 'src')!r}]\n"
        "sys.path.insert(0, %r)\n"
        "import conftest\n"
        "from gpubench.lib import cli, spec, device\n"
        "s = spec.load()\n"
        "for cell in [w['name'] for w in s['workloads']]:\n"
        "    w = spec.cell(s, cell)\n"
        "    cli.run_cell(s, cell, 3, 0.2, True, torch.device('cpu'),\n"
        "        time.perf_counter(),\n"
        "        cfg=conftest.tiny_config(spec.config_file(s, w['config'])),\n"
        "        mix=conftest.tiny_mix(spec.traffic_file(w['traffic'])),\n"
        "        checks=conftest.tiny_checks(spec.checks_file(cell)))\n"
        "print(device.forbidden_loaded())\n"
    ) % str(spec.BENCH / "tests")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
