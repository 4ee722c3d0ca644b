"""The stacked leaves' gradient fills and adds over the traced window (train
cells): the device seconds of the program's ``model.stack_grad`` spans (from
the first of a layer's slices' gradient nodes to the start of the layer
below's backward, ``repro_torch.tracing``) over the window's seconds.  No
reading without the trace, in prefill cells, without device time (the CPU)
or from a program without the recorder."""


def read(r):
    if r["mode"] != "train" or r["summary"] is None \
            or not r["summary"].busy_s:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    t = tracing.total("model.stack_grad")
    if t is None or t.device_s is None:
        return None
    return 100.0 * t.device_s / r["window_s"]
