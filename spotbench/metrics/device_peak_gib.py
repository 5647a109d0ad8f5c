"""The card's allocator peak over set-up and window
(``torch.cuda.max_memory_allocated``), in GiB."""
UNIT = "GiB"


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes else None
