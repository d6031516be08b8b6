"""Host ms a window step waits in ``next()`` on the program's
``device_prefetch``, from the benchmark's own loop."""


def read(ctx):
    w = ctx.window
    if not ctx.train or not w["steps"] or not ctx.trace:
        return None
    return 1e3 * w["data_wait_s"] / w["steps"]
