"""The causal conv's kernel path (``repro_torch.kernels.causal_conv``).

On the CPU: ``ops.causal_conv`` takes the plain versions, which are
``mamba._causal_conv`` in fp32 (bit for bit at fp32, forward and the
gradients of its output), the Mamba2 block's kernel route against its plain
route, the route on the local shards of DTensors (four gloo processes),
and what the wrapper refuses.  On the card (``-m gpu``; they skip
here): the forward and backward kernels against the fp32 plain versions over
widths, lengths, channel counts and strided inputs, the backward's dw and db
bit for bit over two calls, and the kernel spans' calls against the launch
counts.  This file imports no JAX, so it runs on the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_causal_conv.py
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import compare_ulp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402


def inputs(b, s, c, width, dtype, state, device="cpu", seed=0, offset=64,
           extra=72):
    """x as the model hands it over (the conv columns of a wider
    projection, at ``offset``), w, b and the state or None."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(dtype)
    proj = randn(b, s, offset + c + extra)
    return (proj, proj[..., offset:offset + c], randn(width, c, scale=0.4),
            randn(c, scale=0.5), randn(b, width - 1, c) if state else None)


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 7])
@pytest.mark.parametrize("width", [2, 3, 4])
def test_cpu_route_is_causal_conv_bit_for_bit(width, s, state):
    _, x, w, b, st = inputs(2, s, 24, width, torch.float32, state, offset=3,
                            extra=5)
    out, new = ops.causal_conv(x, w, b, st)
    want_out, want_new = M._causal_conv(x, w, b, st)
    assert torch.equal(out, want_out) and torch.equal(new, want_new)


def test_cpu_route_in_bf16_rounds_once():
    _, x, w, b, st = inputs(2, 9, 24, 4, torch.bfloat16, True)
    out, new = ops.causal_conv(x, w, b, st)
    f32 = M._causal_conv(x.float(), w.float(), b.float(), st.float())
    assert out.dtype == new.dtype == torch.bfloat16
    assert torch.equal(out, f32[0].bfloat16())
    assert torch.equal(new, f32[1].bfloat16())


def grads(fn, leaves, dout, dnew=None):
    leaves = [t.detach().clone().requires_grad_() if t is not None else None
              for t in leaves]
    proj, w, b, st = leaves
    out, new = fn(proj[..., 3:27], w, b, st)
    loss = (out * dout).sum()
    if dnew is not None:
        loss = loss + (new * dnew).sum()
    loss.backward()
    return [t.grad for t in leaves if t is not None]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 7])
@pytest.mark.parametrize("width", [2, 3, 4])
def test_cpu_gradients_are_autograd_of_causal_conv(width, s, state):
    """Through the projection's slice, of x, w, b and the state: equal bit
    for bit where only the output is used; within fp32 rounding where the
    new state's gradient is added too (another order of the sums)."""
    proj, _, w, b, st = inputs(2, s, 24, width, torch.float32, state,
                               offset=3, extra=5)
    gen = torch.Generator().manual_seed(1)
    dout = torch.randn((2, s, 24), generator=gen)
    dnew = torch.randn((2, width - 1, 24), generator=gen)
    mine = grads(ops.causal_conv, (proj, w, b, st), dout)
    want = grads(M._causal_conv, (proj, w, b, st), dout)
    assert all(torch.equal(g, e) for g, e in zip(mine, want))
    mine = grads(ops.causal_conv, (proj, w, b, st), dout, dnew)
    want = grads(M._causal_conv, (proj, w, b, st), dout, dnew)
    for g, e in zip(mine, want):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def block():
    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                              dtype="float32")
    ssm, d = cfg.ssm, 64
    params = M.mamba_block_init(torch.Generator().manual_seed(0), d, ssm,
                                torch.float32)
    params["conv_b"] = torch.randn(params["conv_b"].shape,
                                   generator=torch.Generator().manual_seed(1))
    x = torch.randn((2, 40, d), generator=torch.Generator().manual_seed(2))
    return ssm, params, x


def test_block_kernel_route_equals_plain_route_on_the_cpu(block):
    """Forward bit for bit; every parameter's gradient and the input's
    within fp32 rounding (the SSD's plain backward differs from autograd of
    the scan in the order of its sums)."""
    ssm, params, x = block
    outs, all_grads = [], []
    for use_kernel in (False, True):
        p = {k: v.detach().clone().requires_grad_() for k, v in
             params.items()}
        xi = x.clone().requires_grad_()
        out, _ = M.mamba_block_apply(p, xi, ssm, use_kernel=use_kernel)
        out.square().sum().backward()
        outs.append(out)
        all_grads.append({"x": xi.grad, **{k: v.grad for k, v in p.items()}})
    assert torch.equal(outs[0], outs[1])
    for k, g in all_grads[0].items():
        torch.testing.assert_close(all_grads[1][k], g, rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()))


def test_block_kernel_route_carries_the_conv_cache(block):
    ssm, params, x = block
    di = ssm.d_inner(64)
    conv_ch = di + 2 * ssm.n_groups * ssm.state_size
    gen = torch.Generator().manual_seed(3)
    cache = {"conv": torch.randn((2, ssm.conv_width - 1, conv_ch),
                                 generator=gen),
             "state": torch.randn((2, ssm.n_heads(64), ssm.head_dim,
                                   ssm.state_size), generator=gen)}
    caches = [dict(cache), dict(cache)]
    for t0, t1 in ((0, 32), (32, 33), (33, 34)):       # prefill, 2 decodes
        outs = []
        for i, use_kernel in enumerate((False, True)):
            o, caches[i] = M.mamba_block_apply(params, x[:, t0:t1], ssm,
                                               caches[i],
                                               use_kernel=use_kernel)
            outs.append(o)
        torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
        assert torch.equal(caches[0]["conv"], caches[1]["conv"])


@pytest.mark.parametrize("case", ["width 5", "width 1", "float16", "float64",
                                  "w bf16", "w channels", "b shape",
                                  "state shape", "x 2-D"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    x, w, b = torch.ones(2, 8, 16), torch.ones(4, 16), torch.zeros(16)
    st = torch.zeros(2, 3, 16)
    bad = {"width 5": (x, torch.ones(5, 16), b, None),
           "width 1": (x, torch.ones(1, 16), b, None),
           "float16": (x.half(), w.half(), b.half(), None),
           "float64": (x.double(), w.double(), b.double(), st.double()),
           "w bf16": (x, w.bfloat16(), b, None),
           "w channels": (x, torch.ones(4, 12), b, None),
           "b shape": (x, w, torch.zeros(12), None),
           "state shape": (x, w, b, torch.zeros(2, 2, 16)),
           "x 2-D": (x[0], w, b, None)}[case]
    error = TypeError if case in ("float16", "float64", "w bf16") \
        else ValueError
    with pytest.raises(error):
        ops.causal_conv(*bad)


def test_kernel_wrappers_refuse_cpu_tensors():
    x, w, b = torch.ones(2, 8, 16), torch.ones(4, 16), torch.zeros(16)
    with pytest.raises(ValueError):
        cc.causal_conv(x, w, b)
    with pytest.raises(ValueError):
        cc.causal_conv_bwd(x, w, b, None, torch.ones(2, 8, 16), False)


@pytest.mark.parametrize("b,s,c,dtype,rows", [
    (8, 2048, 4352, torch.bfloat16, 64),   # train, and prefill's long rounds
    (8, 4096, 4352, torch.bfloat16, 64),
    (8, 1024, 4352, torch.bfloat16, 32),
    (8, 256, 4352, torch.bfloat16, 8),     # a round of short prompts
    (8, 1, 4352, torch.bfloat16, 8),       # decode
    (8, 2048, 4352, torch.float32, 64),
    (2, 1024, 5248, torch.float32, 16),
])
def test_tile_rows_keep_the_card_in_threads(b, s, c, dtype, rows):
    assert cc.tile_rows(b, s, c, dtype, 132) == rows


def _dtensor_worker(rank, store_path, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.sharded import local_call
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        _, x, w, b, st = inputs(4, 9, 24, 4, torch.float32, True)
        dout = torch.randn((4, 9, 24), generator=torch.Generator()
                           .manual_seed(1))
        ref = [t.detach().clone().requires_grad_() for t in (x, w, b, st)]
        ref_out, ref_new = M._causal_conv(*ref)
        (ref_out * dout).sum().backward()
        results = []
        # channels sharded alike on x and w, and x's channels whole
        for x_pl in ([Shard(0), Shard(2)], [Shard(0), Replicate()]):
            pls = (x_pl, [Replicate(), Shard(1)], [Replicate(), Shard(0)],
                   x_pl)
            leaves = [distribute_tensor(t.detach(), mesh, pl)
                      .requires_grad_() for t, pl in zip((x, w, b, st), pls)]
            bc = {0: "b", 2: "c"}
            out, new = local_call(M._conv_kernel, leaves,
                                  (bc, {1: "c"}, {0: "c"}, bc),
                                  (("b", None, "c"), ("b", None, "c")))
            (out * distribute_tensor(dout, mesh, [Replicate()] * 2)
             ).sum().backward()
            results.append(
                [torch.allclose(out.full_tensor(), ref_out, atol=1e-6),
                 torch.equal(new.full_tensor(), ref_new.detach())]
                + [torch.allclose(t.grad.full_tensor(), r.grad, atol=1e-5)
                   for t, r in zip(leaves, ref)])
        if rank == 0:
            torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


def test_kernel_route_runs_on_local_shards_of_dtensors(tmp_path):
    """Four gloo processes, mesh (2, 2) of data x model: x and the state
    sharded over the batch, their channels sharded like w's or whole; the
    output, the new state and every gradient against ``_causal_conv``."""
    import time

    import torch.multiprocessing as mp
    out_path = tmp_path / "results.pt"
    ctx = mp.start_processes(_dtensor_worker, nprocs=4, join=False,
                             args=(str(tmp_path / "store"), str(out_path)),
                             start_method="spawn")
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("4 processes did not finish within 120 s")
    assert torch.load(out_path) == [[True] * 6] * 2


# ------------------------------------------------------------ the card
@pytest.fixture
def need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")


def assert_within(got: torch.Tensor, ref: torch.Tensor, what: str,
                  rel: float = 1e-5) -> None:
    """``chip_smoke.compare_ulp``'s rule: bf16 within one ulp of the fp32
    reference plus ``rel`` of its largest magnitude, fp32 within 2 ``rel``
    of it."""
    try:
        compare_ulp(got, ref, rel)
    except AssertionError as exc:
        raise AssertionError(f"{what}: {exc}") from None


GPU_CASES = [(c, s, width, state)
             for c in (4352, 5248, 160, 100)
             for s in (1, 2, 255, 2048)
             for width in (2, 3, 4)
             for state in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,s,width,state", GPU_CASES)
def test_kernels_match_the_plain_versions(need_gpu, c, s, width, state):
    """bf16, x a strided slice of a wider projection: the output and the new
    state, then dx, dw, db and dstate against autograd of the fp32 plain
    version.  C = 100 (no multiple of 8) takes the element path."""
    b = 2
    _, x, w, bias, st = inputs(b, s, c, width, torch.bfloat16, state,
                               device="cuda", seed=c + s + width)
    out, new = cc.causal_conv(x, w, bias, st)
    ref = M._causal_conv(x.float(), w.float(), bias.float(),
                         st.float() if st is not None else None)
    assert out.is_contiguous() and out.shape == (b, s, c)
    assert_within(out, ref[0], "out")
    assert torch.equal(new, ref[1].bfloat16())
    dout = torch.randn((b, s, c), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(5)
                       ).bfloat16()
    got = cc.causal_conv_bwd(x, w, bias, st, dout, state)
    want = cc.causal_conv_bwd_plain(x.float(), w.float(), bias.float(),
                                    st.float() if st is not None else None,
                                    dout.float(), state)
    for name, g, e in zip(("dx", "dw", "db", "dstate"), got, want):
        if e is None:
            assert g is None
            continue
        assert g.dtype == torch.bfloat16 and g.shape == e.shape
        assert_within(g, e, name, rel=1e-4 if name in ("dw", "db")
                      else 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("offset,dtype", [(4096, torch.bfloat16),
                                          (3, torch.bfloat16),
                                          (4096, torch.float32)])
def test_kernels_at_mamba2_widths_read_in_place(need_gpu, offset, dtype):
    """The model's layout: C = 4352 at column 4096 of an 8512-wide
    projection (the 16-byte path), and at column 3 (unaligned: the element
    path); fp32 too.  With the state, S = 2048."""
    b, s, c = 2, 2048, 4352
    _, x, w, bias, st = inputs(b, s, c, 4, dtype, True, device="cuda",
                               offset=offset, extra=8512 - c - offset)
    assert x.stride(1) == 8512
    out, new = cc.causal_conv(x, w, bias, st)
    ref = M._causal_conv(x.float(), w.float(), bias.float(), st.float())
    assert_within(out, ref[0], "out")
    assert torch.equal(new, ref[1].to(dtype))
    dout = torch.randn((b, s, c), device="cuda").to(dtype)
    got = cc.causal_conv_bwd(x, w, bias, st, dout, True)
    want = cc.causal_conv_bwd_plain(x.float(), w.float(), bias.float(),
                                    st.float(), dout.float(), True)
    for name, g, e in zip(("dx", "dw", "db", "dstate"), got, want):
        assert_within(g, e, name, rel=1e-4 if name in ("dw", "db") else 1e-5)


@pytest.mark.gpu
def test_backward_repeats_bit_for_bit(need_gpu):
    _, x, w, bias, st = inputs(8, 2048, 4352, 4, torch.bfloat16, True,
                               device="cuda", offset=4096, extra=64)
    dout = torch.randn((8, 2048, 4352), device="cuda").bfloat16()
    first = cc.causal_conv_bwd(x, w, bias, st, dout, True)
    again = cc.causal_conv_bwd(x, w, bias, st, dout, True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_launches_equal_the_kernel_spans(need_gpu):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    _, x, w, bias, st = inputs(2, 64, 4352, 4, torch.bfloat16, False,
                               device="cuda")
    x = x.detach().requires_grad_()
    ops.causal_conv(x, w, bias)[0].sum().backward()      # build and load
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            ops.causal_conv(x, w, bias)[0].sum().backward()
        with torch.no_grad():
            ops.causal_conv(x, w, bias)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    calls = {n: sum(t.calls for (name, _), t in tracing.totals().items()
                    if name == f"kernel.{n}")
             for n in ("causal_conv", "causal_conv_bwd")}
    assert calls == {"causal_conv": 4, "causal_conv_bwd": 3}
    assert {n: launches[n] for n in calls} == calls
    assert all(t.device_s is not None for (n, _), t in
               tracing.totals().items() if n.startswith("kernel.causal"))
