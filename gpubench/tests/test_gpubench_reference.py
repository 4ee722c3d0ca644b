"""Each plain reference against the port's CPU path at a tiny size, in fp32:
the forward's logits, a left-padded prefill's last logits, the loss and
every gradient, and AdamW steps.  (The test imports both; the reference
itself imports nothing of the port.)"""
import ast
import math

import pytest
import torch

from conftest import tiny_config
from gpubench.lib import spec, weights
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop
from repro_torch.core import ShardingPlan

CONFIGS = [c["name"] for c in spec.load()["configs"]]


def setup(name, seed=7):
    s = spec.load()
    cfg = tiny_config(spec.config_file(s, name))
    cfg["dtype"] = "float32"
    model = build_model(weights.arch_config(cfg), "cpu")
    params, leaves = weights.make(model, seed, torch.device("cpu"))
    w = {leaf.path: t for leaf, t in zip(leaves,
                                         adamw.tree_leaves(params))}
    return cfg, model, params, w, spec.reference_module(name)


def close(a, b, tol):
    return float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_imports_nothing_of_the_port(name):
    for path in (spec.BENCH / "reference" / f"{name}.py",
                 spec.BENCH / "reference" / "plain.py"):
        tree = ast.parse(path.read_text())
        mods = {n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)} | {
            a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
        assert not {m for m in mods if m.split(".")[0] in
                    ("repro_torch", "repro", "jax", "chip_smoke")}, mods


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_and_padded_prefill_match_the_port(name):
    cfg, model, params, w, ref = setup(name)
    prec = ref.Precision("fp32")
    tok = weights.tokens(3, 0, 1, 80, cfg["vocab_size"], "cpu")
    logits, _ = model.forward(params, tok)
    from gpubench.reference import plain
    want = plain.head(cfg, w, plain.hidden(cfg, w, tok[0], prec), prec)
    assert close(logits[0], want, 1e-5)
    # a left-padded row as the engine prefills it (token 0, no mask)
    row = torch.cat([torch.zeros(23, dtype=torch.long), tok[0, :41]])
    got, _ = model.prefill(params, row[None], model.init_cache(1, 96))
    assert close(got[0], ref.last_logits(cfg, w, row, prec), 1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_the_port(name):
    cfg, model, params, w, ref = setup(name)
    prec = ref.Precision("fp32")
    tok = weights.tokens(4, 0, 2, 64, cfg["vocab_size"], "cpu")
    loss, _, grads = train_loop.value_and_grad(model, params,
                                               {"tokens": tok})
    live = {k: v.detach().requires_grad_() for k, v in w.items()}
    want = sum(ref.loss(cfg, live, tok[r], prec, remat=False)
               for r in range(2)) / 2
    gw = torch.autograd.grad(want, list(live.values()))
    want = float(want.detach())
    assert abs(float(loss) - want) <= 1e-5 * want
    for (k, g_ref), g in zip(zip(live, gw), adamw.tree_leaves(grads)):
        assert close(g, g_ref, 1e-4), k


@pytest.mark.parametrize("name", CONFIGS)
def test_adamw_steps_match_the_port(name):
    cfg, model, params, w, ref = setup(name)
    opt = spec.traffic_file("train-b8s2048")["adamw"]
    w0 = {k: v.clone() for k, v in w.items()}
    batches = [weights.tokens(5, k, 2, 64, cfg["vocab_size"], "cpu")
               for k in (1, 2)]
    step = train_loop.make_train_step(model, adamw.AdamWConfig(**opt),
                                      ShardingPlan(remat="full"),
                                      use_kernel=True, donate=True)
    state = adamw.init(adamw.AdamWConfig(**opt), params)
    losses = []
    for b in batches:
        params, state, _, m = step(params, state, None, {"tokens": b})
        losses.append(float(m["loss"]))
    out = ref.train(cfg, w0, batches, opt, ref.Precision("fp32"))
    assert all(math.isclose(a, b, rel_tol=1e-5)
               for a, b in zip(losses, out["losses"]))
    for k, p in zip(w0, adamw.tree_leaves(params)):
        got = float(torch.linalg.vector_norm(p - w0[k]))
        assert math.isclose(got, out["change"][k], rel_tol=1e-3,
                            abs_tol=1e-7), k
