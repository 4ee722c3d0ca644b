"""Padded positions over positions prefilled in the traced window, as the
engine counts them (prefill cells): one minus its ``serve.prompt_positions``
(the real history tokens) over its ``serve.prefill_positions`` (each
admission round's rows times its longest history), ``repro_torch.tracing``'s
counters.  No reading without the trace, in train cells, without device time
(the CPU) or from a program without the recorder."""


def read(r):
    if r["mode"] != "prefill" or r["summary"] is None \
            or not r["summary"].busy_s:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    real, padded = (tracing.total(n) for n in ("serve.prompt_positions",
                                               "serve.prefill_positions"))
    if real is None or padded is None or not padded.value:
        return None
    return 100.0 * (1.0 - real.value / padded.value)
