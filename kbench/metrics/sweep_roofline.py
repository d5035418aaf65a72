"""The sweep kernel's share of its roofline: the least time of one index's
saturating update (one code a valid window read, each distinct folded cell
read and written once) over the kernel's device time in one index."""

from kbench import roofline
from kbench.metrics_common import kernel_seconds_per_job

KERNEL = "sweep_sorted_kernel"


def read(run):
    w = run.work
    least = roofline.least_seconds(
        roofline.sweep_bytes(w["valid_windows"], w["distinct_cells"], w["kmer_len"]))
    return roofline.share(least, kernel_seconds_per_job(run, KERNEL))
