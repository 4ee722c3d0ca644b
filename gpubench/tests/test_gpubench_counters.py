"""The operation and byte counters against hand-worked numbers at small
shapes, and against the kernel table's ``bound_ms`` at the main-path
shapes (the repo's kernel notes, H100 SXM peaks)."""

import pytest

from gpubench.lib import counters as c
from gpubench.lib import spec


def test_small_shapes_by_hand():
    # one chunk of 2 rows, b = g = h = p = n = 1: pairs 2 * 3 = 6 for C B^T
    # and for the scores, 4 * l * p * n = 8: 6 + 6 + 8
    f, nbytes = c.ssd_fwd(1, 2, 1, 1, 1, 1, chunk=4)
    assert f == 20
    assert nbytes == (2 * 2 + 2 * 2) * 2 + 4 * 2 + 4
    f, _ = c.ssd_bwd(1, 2, 1, 1, 1, 1, chunk=4)
    assert f == 6 + 6 * 4 + 10 * 2
    f, nbytes = c.flash_fwd(1, 1, 1, 3, 2)
    assert f == 4 * 2 * 6 and nbytes == (2 * 3 * 2 + 2 * 3 * 2) * 2
    assert c.flash_bwd(1, 1, 1, 3, 2)[0] == 10 * 2 * 6
    assert c.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert c.least_seconds(0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("fn,shape,want_ms", [
    (c.ssd_fwd, (8, 2048, 64, 64, 1, 128, 256), 0.0889),
    (c.ssd_bwd, (8, 2048, 64, 64, 1, 128, 256), 0.192),
    (c.ssd_fwd, (8, 2048, 80, 64, 1, 64, 256), 0.106),
    (c.ssd_bwd, (8, 2048, 80, 64, 1, 64, 256), 0.159),
    (c.flash_fwd, (8, 32, 32, 2048, 80), 0.174),
    (c.flash_bwd, (8, 32, 32, 2048, 80), 0.434),
])
def test_main_path_bounds_match_the_kernel_table(fn, shape, want_ms):
    got = c.least_seconds(*fn(*shape)) * 1e3
    assert got == pytest.approx(want_ms, rel=5e-3)


def test_model_flops_by_hand_for_a_tiny_hybrid():
    cfg = {"family": "hybrid", "n_layers": 2, "d_model": 4, "vocab_size": 10,
           "n_heads": 2, "n_kv_heads": 2, "head_dim": 2, "d_ff": 8,
           "gated_mlp": True,
           "ssm": {"state_size": 2, "head_dim": 2, "expand": 2,
                   "chunk_size": 4, "n_groups": 1, "conv_width": 4},
           "hybrid": {"attn_every": 2, "n_shared_attn_blocks": 1}}
    s = 3
    head = 2 * s * 4 * 10
    w_in = 4 * (2 * 8 + 2 * 2 + 4)
    mamba = 2 * s * (w_in + 8 * 4) + c.ssd_fwd(1, s, 4, 2, 1, 2, 4)[0]
    attn = 2 * s * (4 * 4 * 2 + 4 * 4 * 2 + 3 * 4 * 8) \
        + 4 * 2 * 6 * 2
    assert c.forward_flops(cfg, s, s) == head + 2 * mamba + attn
    assert c.train_step_flops(cfg, 5, s) == 3 * 5 * c.forward_flops(
        cfg, s, s - 1)
    assert c.prefill_flops(cfg, s) == c.forward_flops(cfg, s, 1)


def test_full_configs_step_flops():
    s = spec.load()
    m = spec.config_file(s, "mamba2-1.3b")
    # 6 x the weight products a token meets, to within the attention and
    # SSD terms: mamba2 1.34e9 weights in its layers and head
    dense_m = 48 * (2048 * 8512 + 4096 * 2048) + 2048 * 50280
    got = c.train_step_flops(m, 8, 2048)
    assert 6 * dense_m * 8 * 2048 < got < 1.1 * 6 * dense_m * 8 * 2048
