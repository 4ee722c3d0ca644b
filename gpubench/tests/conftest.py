"""CPU tests of the benchmark harness (``python -m pytest -q gpubench/tests``
from the root of the checkout).  Tests marked ``gpu`` need the card and
skip here; they decide so inside the test."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs an NVIDIA GPU; skips without one")


def tiny_config(cfg: dict) -> dict:
    """The configuration at a size a CPU test holds: every width cut, the
    family kept."""
    c = copy.deepcopy(cfg)
    c.update(d_model=64, vocab_size=256, n_layers=2)
    c["ssm"].update(state_size=16, head_dim=16, chunk_size=32)
    return c


def tiny_mix(mix: dict) -> dict:
    m = copy.deepcopy(mix)
    if m["driver"] == "train":
        m.update(rows=2, seq=64)
    else:
        m.update(min_prompt=8, max_prompt=64, max_len=64, epoch_requests=16,
                 slots=4, clients=8)
    return m


def tiny_checks(checks: dict) -> dict:
    c = copy.deepcopy(checks)
    if "check_steps" in c:
        c["check_steps"] = 2
    if "sample" in c:
        c["sample"] = 5
    return c


@pytest.fixture
def need_gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
