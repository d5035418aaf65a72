"""The card's idle share over the traced window: 100 x (1 - the union of its
kernels, copies and fills / the window)."""

from kbench.metrics_common import idle_share


def read(run):
    return idle_share(run)
