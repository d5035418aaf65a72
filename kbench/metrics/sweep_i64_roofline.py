"""The int64 sweep kernel's share of its roofline (K >= 16): the least time
of one index's saturating update (one 8-byte code a valid window read, each
distinct folded cell read and written once) over the int64 instantiation's
device time in one index."""

from kbench import roofline
from kbench.metrics_common import kernel_seconds_per_job

KERNEL = "sweep_sorted_kernel<long>"


def read(run):
    w = run.work
    least = roofline.least_seconds(
        roofline.sweep_bytes(w["valid_windows"], w["distinct_cells"], w["kmer_len"]))
    return roofline.share(least, kernel_seconds_per_job(run, KERNEL))
