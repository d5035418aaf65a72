"""The encode kernel's share of its roofline: the least time of one index's
encode (the genome's bases at 2 bits read, one code a valid window written)
over the kernel's device time in one index."""

from kbench import roofline
from kbench.metrics_common import kernel_seconds_per_job

KERNEL = "encode_packed_kernel"


def read(run):
    w = run.work
    least = roofline.least_seconds(
        roofline.encode_bytes(w["bases"], w["valid_windows"], w["kmer_len"]))
    return roofline.share(least, kernel_seconds_per_job(run, KERNEL))
