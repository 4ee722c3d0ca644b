"""The port's LinReg DS example on the CPU (plain tsmm) against numpy's
least squares and against the reference's tsmm route on the same data."""
import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as ref_ops
from repro_torch.examples import linreg_ds
from repro_torch.kernels import ops


def _problem(m=2048, n=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(np.float32)
    beta_true = rng.standard_normal((n, 1)).astype(np.float32)
    y = x @ beta_true + 0.01 * rng.standard_normal((m, 1)).astype(np.float32)
    return x, y, beta_true


def test_execute_small_matches_lstsq():
    x, y, beta_true = _problem()
    lam = 1e-3
    r = linreg_ds.execute_small(lam=lam, device="cpu", x=torch.from_numpy(x),
                                y=torch.from_numpy(y))
    beta = r["beta"].numpy()
    ref = np.linalg.lstsq(x, y, rcond=None)[0]
    # fp32 normal equations of a well-conditioned 2048 x 128 problem; the
    # ridge of 1e-3 against eigenvalues near 2048 moves beta by about 1e-6
    assert np.abs(beta - ref).max() < 5e-5
    assert np.abs(beta - beta_true).max() < 5e-3      # noise level 0.01
    assert r["max_abs_err_vs_f64"] < 5e-5
    assert (r["m"], r["n"]) == (2048, 128)


def test_execute_small_matches_the_reference_route():
    """Same Gram matrix, right-hand side and solve as the reference's
    execute_small (its tsmm kernel in interpret mode, then the ridge)."""
    x, y, _ = _problem(seed=1)
    lam = 1e-3
    a_ref = ref_ops.tsmm(jnp.asarray(x), bm=512, bn=128) + lam * jnp.eye(128)
    beta_ref = np.asarray(jnp.linalg.solve(a_ref, jnp.asarray(x).T
                                           @ jnp.asarray(y)))
    a = ops.tsmm(torch.from_numpy(x), reg=lam)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=2e-5,
                               atol=2e-4)
    beta = linreg_ds.solve_linreg(torch.from_numpy(x), torch.from_numpy(y),
                                  lam).numpy()
    np.testing.assert_allclose(beta, beta_ref, rtol=1e-4, atol=2e-5)


def test_seeded_problem_is_reproducible():
    a = linreg_ds.execute_small(512, 64, device="cpu", seed=3)
    b = linreg_ds.execute_small(512, 64, device="cpu", seed=3)
    assert torch.equal(a["beta"], b["beta"])
    assert a["max_abs_err_vs_true"] < 1e-2
    c = linreg_ds.execute_small(512, 64, device="cpu", seed=4)
    assert not torch.equal(a["beta"], c["beta"])


def test_main_runs_on_the_cpu(capsys):
    linreg_ds.main(["--m", "512", "--n", "64", "--device", "cpu"])
    assert "solved 512x64" in capsys.readouterr().out
