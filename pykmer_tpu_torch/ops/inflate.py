"""BGZF blocks inflated on the card.

The streaming single-card route's inflate (``host/segments.BgzfInput`` with
a card): a run of whole BGZF blocks, already on the card, inflated into
their places in a device buffer by the hand-written kernel of
``csrc/inflate.cu``, which checks each block's CRC32 and ISIZE and reports a
status a block.

There is no plain torch version: the CPU, and every route that decodes on
the host, inflates with zlib (``host/segments.inflate_blocks``), so a CPU
tensor is refused here.
"""

from __future__ import annotations

import torch

# launches on the card in this process (one a run of blocks)
LAUNCHES = 0

# a block's status
OK, BAD_STREAM, BAD_ISIZE, BAD_CRC = 0, 1, 2, 3
STATUS = {OK: "ok", BAD_STREAM: "bad DEFLATE stream", BAD_ISIZE: "ISIZE mismatch",
          BAD_CRC: "CRC mismatch"}


def inflate_bgzf(comp: torch.Tensor, c_offs: torch.Tensor, u_offs: torch.Tensor,
                 out: torch.Tensor, status: torch.Tensor, c_base: int = 0,
                 u_base: int = 0) -> None:
    """Inflate blocks 0..n-1 (n = ``status``'s length) on ``comp``'s card.

    Block b is the bytes [c_offs[b] - c_base, c_offs[b+1] - c_base) of
    ``comp`` (uint8, 1-D, contiguous, 4-byte aligned, a multiple of 4 bytes
    long) and inflates to [u_offs[b] - u_base, u_offs[b+1] - u_base) of
    ``out`` (uint8, 1-D, contiguous); ``c_offs`` and ``u_offs`` are int64
    with n + 1 entries. ``status`` (int32) receives each block's status
    (``OK``, ``BAD_STREAM``, ``BAD_ISIZE``, ``BAD_CRC``). A block whose
    range lies outside ``comp`` or ``out`` reports ``BAD_STREAM`` or
    ``BAD_ISIZE``; nothing is written outside ``out``. Launches on the
    current stream and does not wait."""
    global LAUNCHES
    tensors = {"comp": comp, "c_offs": c_offs, "u_offs": u_offs, "out": out, "status": status}
    dtypes = {"comp": torch.uint8, "c_offs": torch.int64, "u_offs": torch.int64,
              "out": torch.uint8, "status": torch.int32}
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}: the card inflate takes CUDA tensors "
                             "(the host inflates with zlib, host/segments.inflate_blocks)")
        if t.device != comp.device:
            raise ValueError(f"{name} is on {t.device}, comp on {comp.device}")
        if t.dtype != dtypes[name] or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtypes[name]} tensor")
    n = status.shape[0]
    if c_offs.shape[0] != n + 1 or u_offs.shape[0] != n + 1:
        raise ValueError(f"c_offs and u_offs need {n + 1} entries for {n} blocks")
    if comp.data_ptr() % 4 or comp.shape[0] % 4:
        raise ValueError("comp must be 4-byte aligned and a multiple of 4 bytes long")
    if n == 0:
        return
    from ._build import load

    lib = load()
    stream = torch.cuda.current_stream(comp.device).cuda_stream
    with torch.cuda.device(comp.device):
        err = lib.pykmer_inflate_bgzf(comp.data_ptr(), comp.shape[0], c_offs.data_ptr(),
                                      u_offs.data_ptr(), n, c_base, u_base, out.data_ptr(),
                                      out.shape[0], status.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"inflate launch failed: cudaError_t {err}")
    LAUNCHES += 1
