"""The optimizer's share of the traced window (train cells): the device
seconds of the program's ``train.optimizer`` spans (the gradients placed,
compressed, and AdamW with its global norm and clip,
``repro_torch.tracing``) over the window's seconds.  No reading without the
trace, in prefill cells, without device time (the CPU) or from a program
without the recorder."""


def read(r):
    if r["mode"] != "train" or r["summary"] is None \
            or not r["summary"].busy_s:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    t = tracing.total("train.optimizer")
    if t is None or t.device_s is None:
        return None
    return 100.0 * t.device_s / r["window_s"]
