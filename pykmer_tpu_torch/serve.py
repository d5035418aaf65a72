"""Long-lived indexing/merge service of the port: JSON lines over stdin/stdout.

The protocol of ``pykmer_tpu.serve``: one JSON object per line on stdin, one
JSON response per line on stdout (stderr carries logs), in request order.

  {"cmd": "ping"}                                    -> {"ok": true}
  {"cmd": "warmup", "kmer_len": 15}                  -> pay first-use costs
  {"cmd": "index", "input": "g.fa", "sample": "s1",
   "kmer_len": 15, "bgzip": false, "verify": true}   -> index one FASTA
  {"cmd": "merge", "project": "proj",
   "indexes": ["a.15.kin", ...], "min_count": 1,
   "max_count": 255, "n_shards": 2}                  -> build the .kma
                                                        (n_shards optional)
  {"cmd": "distance", "matrix_file": "proj...kma"}   -> analysis tail
  {"cmd": "shutdown"}                                -> exit 0

Responses always carry {"ok": bool, "cmd": ...}; failures add {"error"} and
the service keeps running (per-job isolation, as in index-batch), a job that
ran out of device memory included. Blank lines are skipped; a line that is
not a JSON object gets an error response. Every job runs on the service's
one ``device``.

On the GPU a CLI process pays, on every run, for the CUDA context, the
kernels' build and load, and the first launch of each library kernel of step
A; a service pays them once, and ``warmup`` pays them before the first job.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, TextIO, Union

import numpy as np
import torch

from .config import IndexConfig

from . import resolve_device

DUMMY_PLANE_CELLS = 1 << 20  # the plane warmup sweeps into (not K's own)


def warmup(kmer_len: int, device: Union[str, torch.device]) -> float:
    """Pay the first-use costs of an index at ``kmer_len`` on ``device`` and
    return the seconds it took: on CUDA the kernels' build and load and the
    CUDA context; then step A of one dummy chunk of the device's chunk size,
    with and without a mask, and a sweep of its codes into a small plane.
    K's own plane is not allocated."""
    from .config import resolve_chunk_windows
    from .index.indexer import ChunkUploader, chunk_sorted_codes
    from .ops.sweep import accumulate_sorted

    device = resolve_device(device)
    t0 = time.monotonic()
    if device.type == "cuda":
        from .ops import _build

        _build.load()
    cw = resolve_chunk_windows(IndexConfig(kmer_len=kmer_len), device).chunk_windows
    span = cw + kmer_len - 1
    bases = np.random.default_rng(0).integers(0, 256, size=(span + 3) // 4,
                                              dtype=np.uint8)
    mask = np.full((span + 7) // 8, 0xFF, dtype=np.uint8)
    upload = ChunkUploader(device, kmer_len, cw)
    plane = torch.zeros(DUMMY_PLANE_CELLS, dtype=torch.uint8, device=device)
    for maskbits in (mask, None):
        codes, _ = chunk_sorted_codes(*upload(bases, maskbits), kmer_len, span)
        accumulate_sorted(plane, codes)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.monotonic() - t0


def _handle(req: dict, device: torch.device) -> dict:
    cmd = req.get("cmd")
    if cmd == "ping":
        return {"ok": True}
    if cmd == "warmup":
        seconds = warmup(int(req["kmer_len"]), device)
        return {"ok": True, "seconds": round(seconds, 2)}
    if cmd == "index":
        from .index import create_fasta_index

        kmer_len = int(req["kmer_len"])
        cfg = IndexConfig(
            kmer_len=kmer_len,
            chunk_windows=req.get("chunk_windows"),
        )
        t0 = time.monotonic()
        header = create_fasta_index(
            req["input"], req["sample"], req["input"], kmer_len,
            overwrite=bool(req.get("overwrite", True)), config=cfg,
            verify=bool(req.get("verify", True)), verbose=False, device=device,
            bgzip=bool(req.get("bgzip")),
        )
        out = header.index_file_root
        if req.get("bgzip"):
            if not req.get("keep_kin", True):
                os.remove(out)
            out += ".bgz"
        return {
            "ok": True,
            "output": str(out),
            "num_kmers": int(header.num_kmers),
            "seconds": round(time.monotonic() - t0, 2),
        }
    if cmd == "merge":
        from .merge import merge

        t0 = time.monotonic()
        kwargs = {}
        for key in ("min_count", "max_count", "block_size", "threads",
                    "n_shards"):
            if key in req:
                kwargs[key] = req[key]
        json_data, _ = merge(
            req["project"], sorted(req["indexes"]), verbose=False,
            device=device, **kwargs
        )
        return {
            "ok": True,
            "samples": len(json_data),
            "seconds": round(time.monotonic() - t0, 2),
        }
    if cmd == "distance":
        from .analysis.distance import load

        t0 = time.monotonic()
        load(req["matrix_file"], names_file=req.get("names_file"))
        return {"ok": True, "seconds": round(time.monotonic() - t0, 2)}
    raise ValueError(f"unknown cmd: {cmd!r}")


def serve(stdin: Optional[TextIO] = None, stdout: Optional[TextIO] = None,
          device: Union[str, torch.device] = "cuda") -> int:
    """Answer requests from ``stdin`` on ``stdout`` until EOF or shutdown."""
    device = resolve_device(device)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as exc:
            print(json.dumps({"ok": False, "error": f"bad json: {exc}"}),
                  file=stdout, flush=True)
            continue
        if not isinstance(req, dict):
            print(json.dumps({"ok": False,
                              "error": "request must be a JSON object"}),
                  file=stdout, flush=True)
            continue
        if req.get("cmd") == "shutdown":
            print(json.dumps({"ok": True, "cmd": "shutdown"}),
                  file=stdout, flush=True)
            return 0
        try:
            resp = _handle(req, device)
        except Exception as exc:  # per-job isolation: the service survives
            resp = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
            if device.type == "cuda":
                # hand back what the failed job left in the caching allocator
                torch.cuda.empty_cache()
        resp["cmd"] = req.get("cmd")
        print(json.dumps(resp), file=stdout, flush=True)
    return 0
