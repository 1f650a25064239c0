"""Device: the share of the traced window in which no kernel, copy or
set ran on the card, in %."""

from codecbench.metrics import idle_share


def read(run):
    return idle_share(run, "encode")
