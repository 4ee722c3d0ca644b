"""The SSD scan's least time over the device seconds of its calls (prefill
cells): each call's least time from its shapes (``r["ssd_least_s"]``, as
``ssd_roofline.prefill``), over the program's ``kernel.ssd_scan`` spans
(``repro_torch.tracing``: everything a call launches, its copies and scratch
with its kernels, and the device's gaps inside it).  No reading without the
trace, in train cells, without device time (the CPU) or from a program
without the recorder."""


def read(r):
    if r["mode"] != "prefill" or r["summary"] is None \
            or not r["summary"].busy_s or r.get("ssd_least_s") is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    t = tracing.total("kernel.ssd_scan")
    if t is None or t.device_s is None:
        return None
    return 100.0 * r["ssd_least_s"] / t.device_s
