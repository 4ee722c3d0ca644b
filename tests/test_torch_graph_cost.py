"""``repro_torch.core.graph_cost.lower_and_cost`` (the port's counterpart of
the reference's ``hlo_cost.lower_and_cost``) against the reference on the
same numpy inputs, and its counting rules on their own.

An fp32 product's FLOPs and bytes equal the reference's exactly.  Traffic
of an elementwise chain does not, by design: eager runs every op unfused,
where XLA fuses the chain into one kernel."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch._subclasses.fake_tensor import FakeTensor

from repro.core.hlo_cost import lower_and_cost as ref_lower_and_cost
from repro_torch.configs import get_config
from repro_torch.core import CompiledCost, h100_single_config
from repro_torch.core.graph_cost import lower_and_cost
from repro_torch.kernels import ops
from repro_torch.models.mamba import ssd_scan_prescaled
from repro_torch.models.model import build_model

SEED = 0


def ref_mesh():
    return Mesh(np.array(jax.devices("cpu")[:1]), ("data",))


@pytest.mark.parametrize("m,k,n,dtype", [(48, 80, 112, "float32"),
                                         (64, 64, 64, "float32"),
                                         (33, 130, 17, "bfloat16")])
def test_matmul_counts_equal_the_reference(m, k, n, dtype):
    rng = np.random.default_rng(SEED)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    _, ref = ref_lower_and_cost("mm", lambda x, y: x @ y,
                                (jnp.asarray(a, dtype), jnp.asarray(b, dtype)),
                                ref_mesh())
    tdtype = getattr(torch, dtype)
    fn = lambda x, y: x @ y                                 # noqa: E731
    got_fn, cost = lower_and_cost("mm", fn, (torch.from_numpy(a).to(tdtype),
                                             torch.from_numpy(b).to(tdtype)))
    assert got_fn is fn
    assert cost.flops_per_device == 2 * m * n * k
    assert (cost.argument_bytes, cost.output_bytes) == (
        ref.argument_bytes, ref.output_bytes)
    if dtype == "float32":
        assert cost.flops_per_device == ref.flops_per_device
        assert cost.bytes_per_device == ref.bytes_per_device
    else:
        # XLA's CPU backend runs a bf16 dot in fp32: it converts both
        # operands and the result, one FLOP an element
        assert ref.flops_per_device == (cost.flops_per_device
                                        + m * k + k * n + m * n)
    assert (cost.num_devices, cost.collectives, cost.unknown_dtypes) == (
        1, [], [])


def test_stream_op_counts_each_eager_op():
    """``a * 1.0001 + 1`` is two ops in eager, each reading its input and
    writing its output; XLA fuses them into one that reads and writes
    once.  The FLOPs agree (one a multiply, one an add), the bytes are
    2 x the reference's: the divergence is by design and kept."""
    n = 1 << 16
    x = np.ones(n, np.float32)
    fn = lambda a: a * 1.0001 + 1.0                         # noqa: E731
    _, ref = ref_lower_and_cost("stream", fn, (jnp.asarray(x),), ref_mesh())
    _, cost = lower_and_cost("stream", fn, (torch.from_numpy(x),))
    in_out = 2 * 4 * n
    assert ref.bytes_per_device == in_out
    assert cost.bytes_per_device == 2 * in_out
    assert cost.flops_per_device == ref.flops_per_device == 2 * n
    # the intermediate product is live beside the output
    assert cost.temp_bytes == 4 * n
    assert cost.peak_memory_bytes == 3 * 4 * n


def test_compiled_cost_round_trips_and_gives_a_roofline():
    rng = np.random.default_rng(SEED)
    a = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32))
    _, cost = lower_and_cost("mm", lambda x: x @ x.T, (a,), dispatch_count=3)
    again = CompiledCost.from_json(json.loads(json.dumps(cost.to_json())))
    assert again == cost and again.dispatch_count == 3
    cc = h100_single_config()
    r = cost.roofline(cc)
    assert r["compute_s"] == cost.flops_per_device / cc.chip.peak("bfloat16")
    assert r["memory_s"] == cost.bytes_per_device / cc.chip.hbm_bw
    assert r["collective_s"] == 0.0 and r["dominant"] == "memory_s"
    bd = cost.time_breakdown(cc)
    assert bd.latency == 3 * cc.dispatch_latency and bd.compute > 0


def test_backward_of_a_traced_function_is_counted():
    """A function that calls ``.backward()`` is costed with its backward:
    the product's two gradient products add 2 x its FLOPs."""
    m, k, n = 40, 24, 56

    def fn(x, w):
        x = x.detach().requires_grad_()
        w = w.detach().requires_grad_()
        (x @ w).sum().backward()
        return x.grad, w.grad

    rng = np.random.default_rng(SEED)
    args = (torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)))
    _, cost = lower_and_cost("fwd_bwd", fn, args)
    _, fwd = lower_and_cost("fwd", lambda x, w: (x @ w).sum(), args)
    # fwd: the product and the sum's m * n inputs; bwd: two products and
    # the sum's gradient broadcast (a view, no FLOPs)
    assert fwd.flops_per_device == 2 * m * n * k + m * n
    assert cost.flops_per_device == fwd.flops_per_device + 2 * (2 * m * n * k)
    assert cost.output_bytes == 4 * (m * k + k * n)


def test_scan_loops_need_no_unrolling():
    """The reference unrolls its ``lax.scan`` bodies for costing
    (``models/costing_mode.py``) because XLA visits a loop body once.
    Eager dispatch sees every iteration: the SSD scan's chunk loop at nc
    chunks counts nc x one chunk, and a model's layer stack counts each
    layer, so the port needs no costing mode."""
    b, h, p, g, n, chunk = 1, 4, 16, 1, 16, 32

    def scan_cost(nc):
        s = nc * chunk
        with torch.device("meta"):
            args = (torch.empty((b, s, h, p)), torch.empty((b, s, h)),
                    torch.empty((b, s, g, n)), torch.empty((b, s, g, n)))
        return lower_and_cost("ssd", lambda *a: ssd_scan_prescaled(
            *a, chunk=chunk), args)[1].flops_per_device

    # F(nc) = F0 + nc x one chunk; F0 is the causal mask, built once
    # (an [L, L] compare and its negation)
    f1, f2, f4 = scan_cost(1), scan_cost(2), scan_cost(4)
    per_chunk = f2 - f1
    assert f4 - f1 == 3 * per_chunk > 0
    assert f1 - per_chunk == 2 * chunk * chunk

    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                              dtype="float32")

    def model_cost(n_layers):
        model = build_model(dataclasses.replace(cfg, n_layers=n_layers),
                            device="cpu")
        params = model.init(SEED)
        tokens = torch.zeros((2, 64), dtype=torch.int64)
        return lower_and_cost("fwd", lambda p, t: model.forward(p, t),
                              (params, tokens))[1].flops_per_device

    f1, f2, f4 = model_cost(1), model_cost(2), model_cost(4)
    assert f4 - f2 == 2 * (f2 - f1) > 0


def test_trace_allocates_nothing_and_launches_nothing():
    """Inside the trace every tensor is fake (no data, no memory), so a
    function that would make a 1 GiB tensor is costed without one, and the
    kernel path's wrappers see CPU tensors: no launch is counted."""
    seen = []

    def fn(x):
        big = x.new_zeros((1 << 28,))                 # 1 GiB of fp32
        seen.extend([x, big])
        return big.sum() + x.sum()

    _, cost = lower_and_cost("big", fn, (torch.ones(8),))
    assert all(isinstance(t, FakeTensor) for t in seen)
    assert cost.temp_bytes >= 4 * (1 << 28)

    cfg = get_config("zamba2-2.7b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(SEED)
    batch = {"tokens": torch.zeros((2, 32), dtype=torch.int64)}
    before = ops.launch_counts()
    _, cost = lower_and_cost("loss", lambda p, b: model.loss(
        p, b, use_kernel=True)[0], (params, batch))
    assert ops.launch_counts() == before
    assert cost.flops_per_device > 0 and cost.unknown_dtypes == []


def test_unknown_dtype_is_counted_at_four_bytes_and_listed():
    x = torch.zeros(16, dtype=torch.complex32)
    _, cost = lower_and_cost("c32", lambda a: a.clone(), (x,))
    assert cost.unknown_dtypes == ["complex32"]
    assert cost.argument_bytes == cost.output_bytes == 4 * 16


def test_more_than_one_device_raises():
    with pytest.raises(TypeError, match="needs a DeviceMesh"):
        lower_and_cost("mm", lambda a: a @ a, (torch.ones(4, 4),),
                       mesh=[torch.device("cpu")] * 2)
    _, cost = lower_and_cost("mm", lambda a: a @ a, (torch.ones(4, 4),),
                             mesh=[torch.device("cpu")])
    assert cost.flops_per_device == 2 * 4 ** 3


def test_sort_counts_as_the_reference_lowers_it():
    """``sort`` (the port's stable top-k) is counted as XLA's
    ``HandleSort`` counts ``jnp.sort``: ``n * ceil(log2 n)`` over the
    operand's ``n`` elements, equal to the reference's count."""
    x = np.random.default_rng(SEED).standard_normal((1, 128, 4)).astype(
        np.float32)
    _, ref = ref_lower_and_cost("sort", lambda a: jnp.sort(a, axis=-1),
                                (jnp.asarray(x),), ref_mesh())
    _, cost = lower_and_cost(
        "sort", lambda a: torch.sort(a, dim=-1, descending=True,
                                     stable=True)[0], (torch.from_numpy(x),))
    assert cost.flops_per_device == ref.flops_per_device == 512 * 9


def test_moe_layer_counts_every_arithmetic_op(monkeypatch):
    """Every op a MoE layer's forward and backward trace (``moe_ffn``:
    the router, the stable top-k, the one-hots by comparison, the cumsum
    of the queue positions, the capacity mask, the dispatch and combine
    products) is counted, or moves data only: no arithmetic op counts 0.
    ``cumsum`` one add an element, ``_softmax`` 5 and its backward 4."""
    from repro_torch.core import graph_cost
    from repro_torch.models import layers as L
    seen = {}
    real = graph_cost._elementwise_flops

    def spy(func, args, kwargs, ins, outs):
        n = real(func, args, kwargs, ins, outs)
        name = func._overloadpacket.__name__
        seen[name] = seen.get(name, 0) + n
        return n
    monkeypatch.setattr(graph_cost, "_elementwise_flops", spy)
    t, d, e, f = 64, 16, 4, 32
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for k, s in (("w_router", (d, e)), ("w_gate", (e, d, f)),
                      ("w_up", (e, d, f)), ("w_down", (e, f, d)))}

    def fwd_bwd(x, p):
        x = x.detach().requires_grad_()
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        with torch.enable_grad():
            out, aux = L.moe_ffn(x, p, top_k=2, capacity_factor=1.25,
                                 gated=True)
            (out.sum() + aux).backward()
        return out.detach()
    lower_and_cost("moe", fwd_bwd, (x, p))
    # allocations, copies, casts and the slice's backward (zeros with the
    # gradient copied in: XLA's pad)
    moves = {"arange", "device", "scalar_tensor", "zeros_like", "new_zeros",
             "zero_", "fill_", "scatter", "expand", "ones_like", "full_like",
             "_to_copy", "_unsafe_view", "clone", "slice_backward"}
    uncounted = {name for name, n in seen.items() if n == 0} - moves
    assert not uncounted
    assert seen["cumsum"] == t * 2 * e
    assert seen["_softmax"] == 5 * t * e
    assert seen["_softmax_backward_data"] == 4 * t * e
    assert seen["sort"] == t * e * 8 and seen["eq"] > 0 and seen["where"] > 0
