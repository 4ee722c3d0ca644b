"""Cost-based plan autotuning (the paper's optimizers in action).

Counterpart of the reference's ``examples/autotune_plan.py``.  For one
(arch x shape x mesh) cell: enumerate the sharding-plan space, rank
analytically with C(P, cc), then show how the ranking responds to a cluster
change (elastic replanning = just re-costing, paper R3).  By default the
meshes are the reference's (one v5e pod, two pods over DCN); ``--h100``
ranks on one H100 node (:func:`~repro_torch.core.cluster.h100_node_config`)
and two (:func:`~repro_torch.core.cluster.h100_multi_node_config`), then
the same "4x DCN" sensitivity on the two nodes' network.

Run:  PYTHONPATH=src python -m repro_torch.examples.autotune_plan [--arch phi3.5-moe-42b-a6.6b] [--h100]
"""
import argparse
import dataclasses

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core.cluster import (h100_multi_node_config, h100_node_config,
                                      multi_pod_config, single_pod_config)
from repro_torch.core.planner import choose_plan, enumerate_plans


def rank(arch, shape, cc, label, k=5):
    print(f"\n== {label}: {len(enumerate_plans(arch, shape, cc))} candidates ==")
    decisions = choose_plan(arch, shape, cc, top_k=k)
    for d in decisions:
        print(f"  {d.plan.describe():66s} T={d.time*1e3:9.1f}ms "
              f"hbm={d.hbm_est/1e9:6.1f}GB feas={d.feasible}")
    return decisions


def main(argv=None):
    """Print the three rankings; return them by label."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3.5-moe-42b-a6.6b",
                    choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--h100", action="store_true",
                    help="rank on one and two H100 nodes instead of v5e pods")
    args = ap.parse_args(argv)
    arch = get_config(args.arch)
    shape = SHAPES[args.shape]

    if args.h100:
        one, two = h100_node_config(), h100_multi_node_config()
        labels = ("one H100 node (1x8, NVLink)",
                  "two H100 nodes (2x1x8, network between)",
                  "two H100 nodes, 4x network")
    else:
        one, two = single_pod_config(), multi_pod_config()
        labels = ("single pod (16x16)", "two pods (2x16x16, DCN between)",
                  "two pods, 4x DCN")
    out = {labels[0]: rank(arch, shape, one, labels[0]),
           labels[1]: rank(arch, shape, two, labels[1])}

    # sensitivity: what if the DCN were 4x faster? (R3: resource awareness)
    fast_chip = dataclasses.replace(two.chip, dcn_bw=two.chip.dcn_bw * 4)
    out[labels[2]] = rank(arch, shape, dataclasses.replace(two, chip=fast_chip),
                          labels[2])
    return out


if __name__ == "__main__":
    main()
