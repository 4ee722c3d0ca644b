"""Padded positions over positions prefilled in the window's admission
rounds: each round's rows times its longest prompt, against the real
prompt tokens (the harness's own count of what it gave the engine)."""


def read(r):
    if r["mode"] != "prefill" or not r["padded_positions"]:
        return None
    return 100.0 * (1.0 - r["real_positions"] / r["padded_positions"])
