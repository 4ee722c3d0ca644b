"""The bf16 SSD-scan body's decomposition and roundings, on the CPU.

``ssd_scan_split_plain`` computes the scan in the order of the tensor-core
body (chunk states, state passing, C B^T once per group, chunk outputs) and
with its roundings (each fp32 operand of a product split into a bf16 hi and
lo part).  It is held here against the reference's Pallas kernel in
interpret mode, against the port's plain version and against the sequential
decode recurrence, so that a wrong decomposition or rounding plan shows
before the CUDA body runs.  Tolerances: 2e-4 in fp32, the reference's own;
bf16 inputs at the serve path's decays get the rule ``chip_smoke.ssd_tol``
holds the kernel to on the card.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_kernel
from repro.models.mamba import ssd_decode_step as ref_ssd_decode_step
from repro_torch.kernels.ssd_scan import ssd_scan_plain, ssd_scan_split_plain
from repro_torch.models.mamba import ssd_decode_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import ssd_tol  # noqa: E402


def prescaled(seed, b, s, h, p, g, n, serve=False):
    """xbar, log_a, B, C as numpy fp32.  dt and A_log drawn as the
    reference's kernel tests draw them, or with ``serve`` as the serve path
    makes them (dt = softplus of a unit normal,
    A_log = log(linspace(1, 16)))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    if serve:
        dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
        a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    else:
        dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
        a_log = rng.uniform(-1, 1, (h,)).astype(np.float32)
    log_a = dt * -np.exp(a_log)
    return (x * dt[..., None], log_a,
            rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32))


def to_np(t):
    return t.to(torch.float32).numpy()


# (b, s, h, p, g, n, chunk): the reference's three sweep cases, a ragged S,
# two groups
CASES = {
    "sweep 1": (2, 128, 4, 16, 1, 32, 32),
    "sweep 2": (1, 256, 2, 64, 1, 128, 64),
    "sweep 3": (2, 64, 8, 32, 1, 16, 16),
    "ragged S = 600": (2, 600, 4, 64, 1, 128, 256),
    "groups G = 2": (2, 256, 8, 64, 2, 128, 64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_plain_matches_the_reference_kernel(case):
    """Against the TPU kernel in interpret mode.  It takes B and C repeated
    to heads and whole chunks only: S = 600 is padded with zero rows, which
    leave y at the real rows and the final state as they are."""
    b, s, h, p, g, n, chunk = CASES[case]
    xbar, log_a, B, C = prescaled(1, b, s, h, p, g, n)
    pad = (-s) % min(chunk, s)

    def jx(a):
        return jnp.asarray(np.pad(a, [(0, 0), (0, pad)]
                                  + [(0, 0)] * (a.ndim - 2)))
    rep = h // g
    ey, es = ssd_scan_kernel(jx(xbar), jx(log_a), jx(np.repeat(B, rep, 2)),
                             jx(np.repeat(C, rep, 2)), chunk=chunk)
    y, st = ssd_scan_split_plain(*(torch.from_numpy(a)
                                   for a in (xbar, log_a, B, C)), chunk=chunk)
    np.testing.assert_allclose(to_np(y), np.asarray(ey)[:, :s], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(to_np(st), np.asarray(es), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("init", [False, True], ids=["zero state",
                                                    "initial state"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_plain_matches_the_plain_version(case, init):
    b, s, h, p, g, n, chunk = CASES[case]
    args = [torch.from_numpy(a) for a in prescaled(2, b, s, h, p, g, n)]
    st0 = torch.from_numpy(np.random.default_rng(3).normal(
        size=(b, h, p, n)).astype(np.float32)) if init else None
    y, st = ssd_scan_split_plain(*args, chunk=chunk, init_state=st0)
    ey, es = ssd_scan_plain(*args, chunk=chunk, init_state=st0)
    np.testing.assert_allclose(to_np(y), to_np(ey), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(to_np(st), to_np(es), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("init", [False, True], ids=["zero state",
                                                    "initial state"])
def test_split_plain_at_the_serve_decays_in_bf16(init):
    """bf16 xbar, B and C at the serve path's decays (|cum| in the hundreds),
    held within the tolerance the kernel is held to on the card."""
    b, s, h, p, g, n, chunk = 1, 512, 8, 64, 1, 128, 256
    xbar, log_a, B, C = (torch.from_numpy(a) for a in
                         prescaled(4, b, s, h, p, g, n, serve=True))
    xbar, B, C = (t.to(torch.bfloat16) for t in (xbar, B, C))
    st0 = torch.from_numpy(np.random.default_rng(5).normal(
        size=(b, h, p, n)).astype(np.float32)) if init else None
    y, st = ssd_scan_split_plain(xbar, log_a, B, C, chunk=chunk,
                                 init_state=st0)
    ey, es = ssd_scan_plain(xbar, log_a, B, C, chunk=chunk, init_state=st0)
    tol = ssd_tol(torch.bfloat16, log_a, chunk, ey, es)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(y), to_np(ey), **tol["y"])
    np.testing.assert_allclose(to_np(st), to_np(es), **tol["state"])


def test_one_bf16_rounding_of_the_state_operand_breaks_the_state_tolerance():
    """The control: the decayed Xbar of the chunk states rounded once to
    bf16, with no lo part, fails the state's fp32 tolerance; the split
    passes it."""
    b, s, h, p, g, n, chunk = CASES["sweep 2"]
    args = [torch.from_numpy(a) for a in prescaled(6, b, s, h, p, g, n)]
    xbar = args[0].to(torch.bfloat16)
    args = [xbar, args[1], args[2].to(torch.bfloat16),
            args[3].to(torch.bfloat16)]
    ey, es = ssd_scan_plain(*args, chunk=chunk)
    tol = ssd_tol(torch.bfloat16, args[1], chunk, ey, es)["state"]
    _, st = ssd_scan_split_plain(*args, chunk=chunk)
    np.testing.assert_allclose(to_np(st), to_np(es), **tol)
    _, bad = ssd_scan_split_plain(*args, chunk=chunk, split_state=False)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(to_np(bad), to_np(es), **tol)


def test_split_plain_matches_the_sequential_decode_recurrence():
    """y and the final state against one-token decode steps, the port's and
    the reference's, from the same inputs (the D residual taken out)."""
    b, s, h, p, g, n = 1, 40, 2, 8, 1, 16
    rng = np.random.default_rng(8)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
    A_log = rng.uniform(-1, 1, (h,)).astype(np.float32)
    B, C = (rng.normal(size=(b, s, g, n)).astype(np.float32)
            for _ in range(2))
    D = np.zeros((h,), np.float32)
    log_a = dt * -np.exp(A_log)
    y, st = ssd_scan_split_plain(
        *(torch.from_numpy(a) for a in (x * dt[..., None], log_a, B, C)),
        chunk=16)
    ref_st = jnp.zeros((b, h, p, n))
    my_st = torch.zeros((b, h, p, n))
    for t in range(s):
        ref_y, ref_st = ref_ssd_decode_step(
            ref_st, *(jnp.asarray(a) for a in (x[:, t], dt[:, t], A_log,
                                                B[:, t], C[:, t], D)))
        my_y, my_st = ssd_decode_step(
            my_st, *(torch.from_numpy(a) for a in (x[:, t], dt[:, t], A_log,
                                                   B[:, t], C[:, t], D)))
        np.testing.assert_allclose(to_np(y[:, t]), np.asarray(ref_y),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(to_np(y[:, t]), to_np(my_y), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_allclose(to_np(st), np.asarray(ref_st), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(to_np(st), to_np(my_st), rtol=2e-4, atol=2e-4)
