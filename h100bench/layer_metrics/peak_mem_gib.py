"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the run up to the
window's close, set-up included, in GiB."""


def read(ctx, variant):
    return ctx.peak_bytes / 2**30
