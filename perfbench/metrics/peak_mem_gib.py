"""peak_mem_gib.*: torch.cuda.max_memory_allocated over the window and
the traced slice (reset after set-up, so the weights and the folds are in
it and set-up's transients are not), in GiB."""


def read(r):
    return r.memory_peak_bytes / 2 ** 30 if r.memory_peak_bytes else None
