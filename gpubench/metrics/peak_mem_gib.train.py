"""The allocator's peak over the window's train steps
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
in GiB."""


def read(r):
    if r["mode"] != "train" or not r["peak_mem_bytes"]:
        return None
    return r["peak_mem_bytes"] / 2 ** 30
