"""Seconds of the index's "bgzip" stage (the `.kin` written again as
`.kin.bgz` + `.gzi` inside the index's finish), the mean over the window's
indexes. Nothing where no index records the stage (an output bgzipped after
the index returned records none)."""

from kbench.spans import mean_seconds


def read(run):
    return mean_seconds(run, "bgzip")
