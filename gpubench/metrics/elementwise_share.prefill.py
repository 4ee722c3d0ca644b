"""Device time in kernels that are neither the port's hand-written kernels
nor library products, over the device's busy time in the window (prefill
cells; the classes are ``gpubench/lib/trace.py``'s rules)."""
from gpubench.lib import readers


def read(r):
    return readers.elementwise_share(r, "prefill")
