"""The int64 encode kernel's share of its roofline (K >= 16): the least time
of one index's encode (the genome's bases at 2 bits read, one 8-byte code a
valid window written) over the int64 instantiation's device time in one
index."""

from kbench import roofline
from kbench.metrics_common import kernel_seconds_per_job

KERNEL = "encode_packed_kernel<long"


def read(run):
    w = run.work
    least = roofline.least_seconds(
        roofline.encode_bytes(w["bases"], w["valid_windows"], w["kmer_len"]))
    return roofline.share(least, kernel_seconds_per_job(run, KERNEL))
