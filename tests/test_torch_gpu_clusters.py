"""The port's H100 cluster grid (``repro_torch.core.gpu_clusters``).

One card, one NVLink node's layouts and 2 and 4 nodes over the network;
the serving grid with the prefill/decode split of each multi-node
candidate.  The grid is built without ``resource.enumerate_clusters`` (it
gives a chip outside ``POD_CHIPS`` a 256-chip pod) and without
``resource._short``; the beam co-search returns the exhaustive winner on
it; and every objective that ranks by price raises, since the card has
none.  Nothing runs on a device."""
import dataclasses
import re

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import gpu_clusters as gc
from repro_torch.core import resource
from repro_torch.core.cluster import H100_SXM, h100_multi_node_config
from repro_torch.core.workload import SERVE_WORKLOADS

ARCH = get_config("qwen1.5-0.5b")
TRAIN = SHAPES["train_4k"]
CHAT = SERVE_WORKLOADS["chat_2k"]


def test_ids_are_unique_and_the_grids_own():
    for grid in (gc.enumerate_h100_clusters(),
                 gc.enumerate_h100_serving_clusters()):
        ids = [c.cid for c in grid]
        assert len(ids) == len(set(ids))
        assert all(re.fullmatch(r"h100-\d+(x\d+)*(-ib)?(\+pd)?", i)
                   for i in ids), ids
    assert [c.cid for c in gc.enumerate_h100_clusters()] == [
        "h100-1", "h100-4x2", "h100-2x4", "h100-2x4x2-ib", "h100-2x2x4-ib",
        "h100-4x4x2-ib", "h100-4x2x4-ib"]


def test_grid_needs_neither_enumerate_clusters_nor_short(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the H100 grid must not call this")
    monkeypatch.setattr(resource, "enumerate_clusters", refuse)
    monkeypatch.setattr(resource, "_short", refuse)
    assert len(gc.enumerate_h100_clusters()) == 7
    assert len(gc.enumerate_h100_serving_clusters()) == 11


def test_chips_and_network():
    multi_chip = h100_multi_node_config().chip
    assert multi_chip.dcn_bw == 400e9
    assert multi_chip == dataclasses.replace(H100_SXM, dcn_bw=400e9)
    for c in gc.enumerate_h100_clusters():
        assert c.cc.chip.name == "h100_sxm"
        if "pod" in c.cc.mesh_axes:
            assert c.cc.mesh_axes[0] == "pod"
            assert c.cc.chip == multi_chip
            assert c.cc.link_class("pod") == "dcn"
        else:
            assert c.cc.chip == H100_SXM


@pytest.mark.parametrize("nodes, products", [
    ((1, 2, 4), [1, 8, 8, 16, 16, 32, 32]), ((1,), [1, 8, 8]),
    ((2,), [1, 16, 16]), ((4,), [1, 32, 32])])
def test_mesh_products(nodes, products):
    grid = gc.enumerate_h100_clusters(node_counts=nodes)
    assert [c.cc.num_chips for c in grid] == products
    node = resource.mesh_factorizations(8, 2)
    inner = [(c.cc.mesh_shape[-2:], c.cc.mesh_axes[-2:]) for c in grid[1:]]
    assert inner == node * (len(grid[1:]) // len(node))
    assert {c.cc.num_chips for c in gc.enumerate_h100_clusters()} == {
        1, 8, 16, 32}


def test_one_mesh_variant():
    grid = gc.enumerate_h100_clusters(mesh_variants=1)
    assert [c.cid for c in grid] == ["h100-1", "h100-4x2", "h100-2x4x2-ib",
                                     "h100-4x4x2-ib"]


def test_serving_grid_splits_each_multi_node_candidate():
    grid = gc.enumerate_h100_serving_clusters()
    colocated = [c for c in grid if c.colocated]
    split = [c for c in grid if not c.colocated]
    assert [c.cid for c in colocated] == [
        c.cid for c in gc.enumerate_h100_clusters()]
    assert [c.cid for c in split] == [
        c.cid + "+pd" for c in gc.enumerate_h100_clusters()
        if "pod" in c.cc.mesh_axes]
    for c in split:
        p = c.handoff_cc.mesh_shape[0]
        assert c.handoff_axis == "pod" and p in (2, 4)
        assert c.prefill_cc.num_chips == 8
        assert c.decode_cc.num_chips == 8 * max(p - 1, 1)


@pytest.mark.parametrize("objective, slo", [("step_time", None),
                                            ("slo", 0.5),
                                            ("device_seconds", None)])
def test_beam_equals_exhaustive_for_train(objective, slo):
    beam = gc.optimize_h100(ARCH, TRAIN, objective=objective, slo=slo)
    ex = gc.optimize_h100(ARCH, TRAIN, objective=objective, slo=slo,
                          search="exhaustive")
    assert beam[0].feasible
    assert (beam[0].cluster_id, beam[0].decision.plan) == (
        ex[0].cluster_id, ex[0].decision.plan)


def test_device_seconds_ranks_by_time_times_cards():
    ranked = gc.optimize_h100(ARCH, TRAIN, objective="device_seconds")
    assert not any(rd.pruned for rd in ranked)
    feasible = [rd for rd in ranked if rd.feasible]
    keys = [rd.device_seconds for rd in feasible]
    assert keys == sorted(keys)
    # each cluster's plan is its fastest: the step_time exhaustive scan's
    fastest = {rd.cluster_id: rd.time for rd in gc.optimize_h100(
        ARCH, TRAIN, search="exhaustive")}
    assert all(rd.time == fastest[rd.cluster_id] for rd in ranked)


def _winner_id(d):
    pf = d.prefill_decision.plan.describe() if d.prefill_decision else "-"
    return (f"{d.cluster_id}@B{d.slots}"
            f"+{d.decode_decision.plan.describe()}/{pf}")


def test_beam_equals_exhaustive_for_serving():
    beam = gc.optimize_h100(ARCH, CHAT)
    ex = gc.optimize_h100(ARCH, CHAT, search="exhaustive")
    assert beam[0].objective.kind == "ttft_p99"
    assert beam[0].feasible
    assert _winner_id(beam[0]) == _winner_id(ex[0])


@pytest.mark.parametrize("objective", ["cost", "cost_per_step", "job_cost",
                                       "cost_per_job", "job"])
def test_dollar_objectives_raise_for_train(objective):
    with pytest.raises(ValueError, match="cost_per_chip_hour is 0.0"):
        gc.optimize_h100(ARCH, TRAIN, objective=objective)


def test_tokens_per_dollar_raises_for_serving():
    with pytest.raises(ValueError, match="no price is assumed"):
        gc.optimize_h100(ARCH, CHAT, objective="tokens_per_dollar")


def test_the_mirrored_chip_keeps_no_price():
    """The reason the dollar objectives raise: the chip spec's price."""
    assert H100_SXM.cost_per_chip_hour == 0.0
    assert gc.check_objective("device_seconds") == "device_seconds"
