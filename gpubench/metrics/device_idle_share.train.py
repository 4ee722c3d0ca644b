"""One minus the union of the device's intervals over the traced window
(train cells)."""
from gpubench.lib import readers


def read(r):
    return readers.idle_share(r, "train")
