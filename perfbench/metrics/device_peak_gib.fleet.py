"""torch.cuda.max_memory_reserved() over the window, in GiB: the device
memory the process holds while it serves the window, the graphs' private
pools and the blocks cached from set-up's eager first uses included (the
allocated peak sees neither: a replay allocates nothing), plus the
window's inputs and its kept results."""


def read(ctx):
    if not ctx.fleet or ctx.reserved_window_bytes <= 0:
        return None
    return ctx.reserved_window_bytes / 2 ** 30
