"""Share of the window in which no operation ran on the card, %: one
less the device's busy time a traced batch (the union of its activity)
over the untraced window's time a batch."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx) if not ctx.train else None
