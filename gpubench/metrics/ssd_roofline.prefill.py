"""The SSD scan's least time over its measured device time in the window
(prefill cells): each call's least time from its shapes
(``gpubench/lib/counters.py``), the calls counted by the port's launch
counters; the time is that of the kernels ``trace.SSD_RE`` names.  No
reading when no kernel matches or the calls could not be counted."""
from gpubench.lib import readers
from gpubench.lib.trace import SSD_RE


def read(r):
    return readers.roofline(r, "prefill", "ssd_least_s", SSD_RE)
