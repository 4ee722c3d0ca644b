"""Batched serving example (counterpart of ``examples/serve_lm.py``):
prefill + decode with caches via the ServeEngine's continuous-batching
core, on a reduced model in fp32, on the GPU unless ``--device cpu`` is
given.

Two runs of the same traffic: static batching (every request admitted in
one round, the degenerate continuous schedule), then a 2-slot continuous
pool that must refill lanes as requests finish: the executable twin of the
costed slot-refill schedules in ``repro_torch.core.serving``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.runtime.serve_engine import EngineConfig, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    arch = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                               dtype="float32")
    model = build_model(arch, args.device)
    params = model.init(0)

    rng = np.random.default_rng(0)
    requests = [
        Request(prompt=[int(t) for t in
                        rng.integers(1, arch.vocab_size, size=n)],
                max_new_tokens=12)
        for n in (8, 12, 16, 16)
    ]

    # -- static batching: one admission round, lockstep decode ----------
    engine = ServeEngine(model, params,
                         EngineConfig(max_len=96, batching="static"))
    outs = engine.generate(requests)
    for i, c in enumerate(outs):
        print(f"req{i}: |prompt|={len(c.prompt):2d} "
              f"decode {c.decode_time_s * 1e3:4.0f}ms -> {c.tokens}")
    print(f"\nstatic batch of {len(requests)}: "
          f"prefill {outs[0].prefill_time_s * 1e3:.0f}ms, "
          f"stats {engine.stats}, device {model.device}, kernels "
          f"{'on' if engine.use_kernel else 'off'}")

    # same requests again: greedy decoding is deterministic
    outs2 = engine.generate(requests)
    assert [c.tokens for c in outs] == [c.tokens for c in outs2]
    print("determinism check passed")

    # -- continuous batching: 2 slots over 4 requests --------------------
    pool = ServeEngine(model, params,
                       EngineConfig(max_len=96, batching="continuous",
                                    slots=2))
    for r in requests:
        pool.submit(r)
    done = pool.run()
    assert len(done) == len(requests)
    print(f"\ncontinuous, slots=2: {pool.stats['admission_rounds']} "
          f"admission rounds, {pool.stats['decode_steps']} decode steps, "
          f"{pool.stats['wasted_slot_steps']} wasted slot-steps")
    for c in done:
        print(f"req{c.rid}: prefill {c.prefill_time_s * 1e3:4.0f}ms "
              f"decode {c.decode_time_s * 1e3:4.0f}ms "
              f"({len(c.tokens)} tokens)")


if __name__ == "__main__":
    main()
