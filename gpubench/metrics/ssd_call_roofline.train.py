"""The SSD scan's least time over the device seconds of its calls (train
cells): each call's least time from its shapes (``r["ssd_least_s"]``, as
``ssd_roofline.train``), over the program's ``kernel.ssd_scan`` and
``kernel.ssd_scan_bwd`` spans (``repro_torch.tracing``: everything a call
launches, its copies, scratch and fixed-order sums with its kernels, and the
device's gaps inside it).  No reading without the trace, in prefill cells,
without device time (the CPU) or from a program without the recorder."""


def read(r):
    if r["mode"] != "train" or r["summary"] is None \
            or not r["summary"].busy_s or r.get("ssd_least_s") is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    calls = [tracing.total(n) for n in ("kernel.ssd_scan",
                                        "kernel.ssd_scan_bwd")]
    if any(t is None or t.device_s is None for t in calls):
        return None
    return 100.0 * r["ssd_least_s"] / sum(t.device_s for t in calls)
