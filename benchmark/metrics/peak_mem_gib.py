"""peak_mem_gib: `torch.cuda.max_memory_allocated()` over the window (the
statistics reset at its start), in GiB: what caps the batch a user can fit.
Read by the benchmark from the card's caching allocator."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30
