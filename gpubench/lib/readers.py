"""What the per-layer readers share: each metric file in
``gpubench/metrics/`` is one call of a function here with the traffic mode
(``"train"`` or ``"prefill"``) that its name ends in.  A reader returns
None where it has nothing to read: another mode's run, a run without the
trace, or no kernel that its rule names."""
from __future__ import annotations

import re
from typing import Optional

from gpubench.lib.trace import kernel_class_seconds


def _summary(r: dict, mode: str):
    return r["summary"] if r["mode"] == mode else None


def idle_share(r: dict, mode: str) -> Optional[float]:
    """One minus the union of the device's intervals over the traced
    window, in %."""
    s = _summary(r, mode)
    if s is None:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def elementwise_share(r: dict, mode: str) -> Optional[float]:
    """Device time in kernels that are neither the port's hand-written
    kernels nor library products, over the device's busy time, in %."""
    s = _summary(r, mode)
    if s is None or s.busy_s <= 0:
        return None
    return 100.0 * kernel_class_seconds(s)["other"] / s.busy_s


def roofline(r: dict, mode: str, least_key: str,
             kernels: "re.Pattern") -> Optional[float]:
    """The calls' least time (``r[least_key]``, from their shapes) over the
    device time of the kernels that ``kernels`` names, in %."""
    s = _summary(r, mode)
    if s is None or r.get(least_key) is None:
        return None
    t = s.seconds(kernels)
    return None if not t else 100.0 * r[least_key] / t
