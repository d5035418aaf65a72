"""Job kind ``index_bgzf``: the ``index`` job on the genome as it is
shipped, a BGZF ``.fa.gz``, as a user indexes a downloaded assembly.

Set-up writes the configuration's genome from the seed, as ``jobs/index.py``
does, notes the sha256 of the FASTA it wrote, and compresses it into BGZF as
htslib's ``bgzip`` does (the configuration's ``input``: payloads of
``block_payload`` bytes deflated at ``level``, each block a gzip member with
the ``BC`` subfield and its CRC32 and ISIZE, then the 28-byte EOF block),
with the standard library's zlib on a thread pool over every core; the plain
FASTA is then removed. The warm index is of a ``warm_bp`` genome made and
compressed alike. Each call indexes a link ``g{i:03d}.fa.gz`` to the one
file.

The check inflates the file with the standard library's ``gzip`` and
requires the sha256 of those bytes to be the FASTA's; where it is not,
every call is wrong. It then judges the calls as ``jobs/index.py`` does,
with the compressed file's sha256 as the input checksum the `.kin.json`
carries, under the same limits.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import torch

from kbench import genome
from kbench.jobs import index

LIMITS = index.LIMITS
end_to_end = index.end_to_end

EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
BLOCKS_A_TASK = 256  # blocks one thread deflates at a time
_HEADER = struct.Struct("<4BI2BH2BHH")  # gzip header, XLEN, the BC subfield and BSIZE
_FOOTER = struct.Struct("<2I")  # CRC32, ISIZE


def _block(payload: memoryview, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    deflated = co.compress(payload) + co.flush()
    bsize = _HEADER.size + len(deflated) + _FOOTER.size
    if bsize > 1 << 16:
        raise ValueError("a BGZF block above 64 KiB: the payload does not compress")
    return (_HEADER.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 0x42, 0x43, 2, bsize - 1)
            + deflated + _FOOTER.pack(zlib.crc32(payload), len(payload)))


def bgzip(data: bytes, path: str, block_payload: int, level: int,
          eof_block: bool = True) -> int:
    """Write ``data`` to ``path`` as BGZF; returns the number of blocks. The
    blocks deflate on a thread pool of one thread a core (zlib releases the
    GIL)."""
    view = memoryview(data)
    starts = range(0, len(data), block_payload)
    tasks = [starts[i: i + BLOCKS_A_TASK] for i in range(0, len(starts), BLOCKS_A_TASK)]

    def deflate(task) -> bytes:
        return b"".join(_block(view[s: s + block_payload], level) for s in task)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool, open(path, "wb") as fh:
        for part in pool.map(deflate, tasks):
            fh.write(part)
        if eof_block:
            fh.write(EOF_BLOCK)
    return len(starts) + eof_block


def _compressed(run, fasta: str) -> Tuple[str, str, int]:
    """``fasta`` as the configuration's BGZF file beside it, the plain file
    removed: (its path, the FASTA's sha256, its blocks)."""
    spec = run.config["input"]
    with open(fasta, "rb") as fh:
        data = fh.read()
    index._remove(run, fasta)
    path = os.path.splitext(fasta)[0] + spec["suffix"]
    blocks = bgzip(data, path, spec["block_payload"], spec["level"], spec["eof_block"])
    return path, hashlib.sha256(data).hexdigest(), blocks


def setup(run) -> None:
    from pykmer_tpu_torch import create_fasta_index

    cfg, wl = run.config, run.workload
    k = cfg["kmer_len"]
    t0 = time.perf_counter()
    spec = genome.spec(cfg)
    fasta = os.path.join(run.directory, "genome.fa")
    run.state["records"] = genome.make_genome(fasta, run.seed, **spec)
    run.state["bases"] = genome.genome_bases(run.state["records"])
    inflated = os.path.getsize(fasta)
    t1 = time.perf_counter()
    path, run.state["fasta_sha256"], blocks = _compressed(run, fasta)
    run.state["fasta"] = path  # the input: its sha256 is the one `.kin.json` carries
    index._sync(path)
    t2 = time.perf_counter()
    warm = os.path.join(run.directory, "warm.fa")
    genome.make_genome(warm, run.seed + 1, **dict(
        spec, genome_bp=wl["warm_bp"], records=1,
        n_bases=spec["n_bases"] * wl["warm_bp"] // spec["genome_bp"]))
    warm = _compressed(run, warm)[0]
    create_fasta_index(warm, "warm", warm, k, config=index._index_config(run, k),
                       verify=wl["verify"], verbose=False, device=run.device)
    size = os.path.getsize(path)
    run.state["info"] = {"setup_inputs_s": t1 - t0, "setup_bgzip_s": t2 - t1,
                         "setup_warm_s": time.perf_counter() - t2, "bgzf_bytes": size,
                         "bgzf_blocks": blocks, "inflated_bytes": inflated,
                         "bgzf_ratio": inflated / size}
    for name in os.listdir(run.directory):
        if name.startswith("warm.fa"):
            index._remove(run, os.path.join(run.directory, name))


def _link(run, i: int) -> str:
    return os.path.join(run.directory, f"g{i:03d}{run.config['input']['suffix']}")


def call(run, i: int) -> Dict:
    from pykmer_tpu_torch import create_fasta_index

    link, k = _link(run, i), run.config["kmer_len"]
    os.symlink(run.state["fasta"], link)
    create_fasta_index(link, f"g{i:03d}", link, k, config=index._index_config(run, k),
                       verify=run.workload["verify"], verbose=False, device=run.device)
    return {"bases": run.state["bases"], "kin": f"{link}.{k:02d}.kin"}


def control(run, i: int) -> Dict:
    """The control in the program's place: the reference with the
    saturation at 255 broken (counts wrap at 256), its `.kin` and
    `.kin.json` written where a call writes them."""
    link, k = _link(run, i), run.config["kmer_len"]
    plane, meta = index.reference(run, cells=lambda counts: (counts % 256).to(torch.uint8))
    kin = f"{link}.{k:02d}.kin"
    plane.cpu().numpy().tofile(kin)
    with open(kin + ".json", "w") as fh:
        json.dump(meta, fh)
    return {"bases": run.state["bases"], "kin": kin}


def inflated_sha256(path: str) -> str:
    """sha256 of the bytes the standard library's gzip inflates ``path`` to."""
    h = hashlib.sha256()
    with gzip.open(path, "rb") as fh:
        while True:
            piece = fh.read(64 << 20)
            if not piece:
                return h.hexdigest()
            h.update(piece)


def check(run) -> Dict[str, Tuple[float, float]]:
    matches = inflated_sha256(run.state["fasta"]) == run.state["fasta_sha256"]
    checks = index.check(run)
    run.state["info"]["inflated_matches_fasta"] = matches
    if not matches:
        run.state["jobs_wrong"] = max(len(run.completed), 1)
    return checks

