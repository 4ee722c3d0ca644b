"""The prefill's share of the card's bf16 peak: the model FLOPs of the real
prompt tokens answered in the window (2 x the weight products a token goes
through, plus attention and the SSD scan; padding not counted) over the
window's seconds and 989 TFLOP/s."""
from gpubench.lib.device import PEAK_BF16_FLOPS


def read(r):
    if r["mode"] != "prefill":
        return None
    return 100.0 * r["model_flops"] / r["window_s"] / PEAK_BF16_FLOPS
