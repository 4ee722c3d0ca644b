"""The whole train step's share of the card's bf16 peak: the model FLOPs
of the window's steps (``gpubench/lib/counters.py``: 6 x the weight
products a token goes through, plus attention and the SSD scan) over the
window's seconds and 989 TFLOP/s."""
from gpubench.lib.device import PEAK_BF16_FLOPS


def read(r):
    if r["mode"] != "train":
        return None
    return 100.0 * r["model_flops"] / r["window_s"] / PEAK_BF16_FLOPS
