"""The traffic generators and the weights repeat for a seed and differ
across seeds; every seed sees the same prompt lengths in another order."""
import collections

import numpy as np
import torch

from conftest import tiny_config
from gpubench.drivers.prefill import Prompts, check_sample
from gpubench.lib import spec, weights
from repro_torch.models.model import build_model

MIX = spec.traffic_file("prefill-c16-256to4096")
BIG = 3_000_000_017          # above 2**31, as a run's seeds may be


def test_prompts_repeat_for_a_seed_and_differ_across_seeds():
    a, b, c = Prompts(MIX, BIG, 32000), Prompts(MIX, BIG, 32000), \
        Prompts(MIX, BIG + 1, 32000)
    ks = range(0, 200, 7)
    assert [a.tokens(k) for k in ks] == [b.tokens(k) for k in ks]
    assert [a.length(k) for k in range(64)] != [c.length(k)
                                                for k in range(64)]
    assert a.tokens(3) != c.tokens(3)


def test_every_seed_and_epoch_holds_the_same_lengths_and_rounds():
    n, slots = MIX["epoch_requests"], MIX["slots"]
    want = None
    for seed in (0, 1, BIG):
        p = Prompts(MIX, seed, 32000)
        for e in range(3):
            lens = [p.length(e * n + i) for i in range(n)]
            rounds = collections.Counter(
                tuple(sorted(lens[r:r + slots])) for r in range(0, n, slots))
            want = want or rounds
            assert rounds == want
    flat = sorted(x for r in want for x in r for _ in range(want[r]))
    assert flat[0] >= MIX["min_prompt"] and flat[-1] <= MIX["max_prompt"]
    # log-uniform quantiles: the median near the geometric mean
    assert abs(np.log(np.median(flat)) - np.log(np.sqrt(256 * 4096))) < 0.1


def test_the_check_sample_takes_every_row_and_the_longest():
    slots, p = MIX["slots"], Prompts(MIX, BIG, 32000)
    ks = {1000 + k: k for k in range(3, 300)}           # rid -> k
    lengths = {r: p.length(k) for r, k in ks.items()}
    a = check_sample(ks, lengths, slots, 81, BIG)
    assert a == check_sample(ks, lengths, slots, 81, BIG)
    assert a != check_sample(ks, lengths, slots, 81, BIG + 1)
    assert len(a) == len(set(a)) == 81
    assert lengths[a[0]] == max(lengths.values())
    rows = collections.Counter(ks[r] % slots for r in a[1:])
    assert sorted(rows) == list(range(slots))
    assert set(rows.values()) == {10}


def test_prompt_tokens_lie_in_the_vocabulary():
    p = Prompts(MIX, BIG, 50280)
    toks = np.concatenate([p.tokens(k) for k in range(20)])
    assert toks.min() >= 1 and toks.max() < 50280


def test_train_batches_repeat_and_differ():
    t = lambda seed, k: weights.tokens(seed, k, 8, 64, 32000, "cpu")  # noqa
    assert torch.equal(t(BIG, 1), t(BIG, 1))
    assert not torch.equal(t(BIG, 1), t(BIG, 2))
    assert not torch.equal(t(BIG, 1), t(BIG + 1, 1))
    rows = t(BIG, 1)
    assert len({tuple(r.tolist()) for r in rows}) == 8


def test_weights_repeat_for_a_seed_leaf_by_leaf_and_differ_across_seeds():
    cfg = tiny_config(spec.config_file(spec.load(), "mamba2-1.3b"))
    model = build_model(weights.arch_config(cfg), "cpu")
    _, leaves = weights.leaf_specs(model)
    dev = torch.device("cpu")
    a = [weights.draw(leaf, BIG, dev) for leaf in leaves]
    b = [weights.draw(leaf, BIG, dev) for leaf in reversed(leaves)][::-1]
    c = [weights.draw(leaf, BIG + 1, dev) for leaf in leaves]
    for leaf, x, y, z in zip(leaves, a, b, c):
        assert x.shape == leaf.shape and x.dtype == leaf.dtype
        assert torch.equal(x, y), leaf.path
        assert not torch.equal(x, z), leaf.path
