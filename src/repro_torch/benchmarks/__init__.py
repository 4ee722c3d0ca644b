"""The port's benchmarks (counterparts of the reference's ``benchmarks/``):
the paper's tables and the plan-search gates through the port's cost model,
and estimates held against runs on the card (``bench_accuracy``,
``bench_calibrate``, ``bench_fusion``).  ``python -m
repro_torch.benchmarks.run`` runs them all."""
