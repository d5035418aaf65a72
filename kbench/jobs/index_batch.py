"""Job kind ``index_batch``: the reference's batch recipe on the genome as
it is shipped. Each call is ``index_batch([g{i:03d}.fa.gz], K, bgzip=True)``
on a link to the one BGZF file, as ``index-batch K *.fa.gz --bgzip`` runs it
a file: the `.kin` and `.kin.json`, then the `.kin.bgz` and its `.gzi`.

Set-up is ``jobs/index_bgzf.py``'s (the genome from the seed, compressed as
``bgzip`` compresses it), with the warm index also through ``index_batch``,
``bgzip`` off: the deflate builds and loads nothing a later call could reuse
(the native library is loaded by the index itself), and at K=15 the warm
plane is 1 GiB whatever the warm genome's size. A call whose input the batch
reports as failed raises.

The check is ``jobs/index_bgzf.py``'s (the `.kin` and `.kin.json` of every
call against the plain reference), and each call's `.kin.bgz` and `.gzi`
against its `.kin`, with the standard library alone:

- ``bgz_bytes_wrong``: the bytes where the inflate of the `.kin.bgz`'s
  blocks differs from the `.kin`, plus the difference in length, summed over
  the calls;
- ``bgz_fields_wrong``: blocks with a wrong BSIZE (the deflate stream does
  not end where it says), CRC32 or ISIZE, or a payload above the
  configuration's ``block_payload``; a missing EOF block; `.gzi` entries that
  differ from the walked offsets; summed over the calls;
- ``bgz_blocks_unequal``: of one block in ``SAMPLE_EVERY``, chosen from the
  seed, those whose deflated bytes differ from
  ``zlib.compressobj(level, DEFLATED, -15)`` of the same payload, so any
  level but the configuration's fails; summed over the calls.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from kbench import genome
from kbench.jobs import index, index_bgzf

LIMITS = dict(index_bgzf.LIMITS, bgz_bytes_wrong=0, bgz_fields_wrong=0,
              bgz_blocks_unequal=0)
end_to_end = index.end_to_end

SAMPLE_EVERY = 16  # one block in this many is deflated again for bgz_blocks_unequal
BLOCKS_A_BATCH = 1024  # blocks inflated at a time by the check's threads
_GZI = struct.Struct("<QQ")


def _batch(run, path: str, bgzip: bool = True) -> None:
    from pykmer_tpu_torch.index import index_batch

    k = run.config["kmer_len"]
    result = index_batch([path], k, config=index._index_config(run, k), overwrite=True,
                         bgzip=bgzip, verify=run.workload["verify"], verbose=False,
                         device=run.device)
    if result.failed or result.indexed != [path]:
        raise RuntimeError(f"index_batch of {path}: {result.failed or 'not indexed'}")


def setup(run) -> None:
    cfg, wl = run.config, run.workload
    t0 = time.perf_counter()
    spec = genome.spec(cfg)
    fasta = os.path.join(run.directory, "genome.fa")
    run.state["records"] = genome.make_genome(fasta, run.seed, **spec)
    run.state["bases"] = genome.genome_bases(run.state["records"])
    inflated = os.path.getsize(fasta)
    t1 = time.perf_counter()
    path, run.state["fasta_sha256"], blocks = index_bgzf._compressed(run, fasta)
    run.state["fasta"] = path
    index._sync(path)
    t2 = time.perf_counter()
    warm = os.path.join(run.directory, "warm.fa")
    genome.make_genome(warm, run.seed + 1, **dict(
        spec, genome_bp=wl["warm_bp"], records=1,
        n_bases=spec["n_bases"] * wl["warm_bp"] // spec["genome_bp"]))
    _batch(run, index_bgzf._compressed(run, warm)[0], bgzip=False)
    size = os.path.getsize(path)
    run.state["info"] = {"setup_inputs_s": t1 - t0, "setup_bgzip_s": t2 - t1,
                         "setup_warm_s": time.perf_counter() - t2, "bgzf_bytes": size,
                         "bgzf_blocks": blocks, "inflated_bytes": inflated,
                         "bgzf_ratio": inflated / size}
    for name in os.listdir(run.directory):
        if name.startswith("warm.fa"):
            index._remove(run, os.path.join(run.directory, name))


def call(run, i: int) -> Dict:
    link, k = index_bgzf._link(run, i), run.config["kmer_len"]
    os.symlink(run.state["fasta"], link)
    _batch(run, link)
    return {"bases": run.state["bases"], "kin": f"{link}.{k:02d}.kin"}


def control(run, i: int) -> Dict:
    """The control in the program's place: ``jobs/index_bgzf.py``'s (counts
    that wrap at 256), and its `.kin` as a sound `.kin.bgz` and `.gzi`,
    written where a call writes them."""
    out = index_bgzf.control(run, i)
    spec = run.config["output"]
    with open(out["kin"], "rb") as fh:
        data = fh.read()
    bgz = out["kin"] + ".bgz"
    index_bgzf.bgzip(data, bgz, spec["block_payload"], spec["level"], spec["eof_block"])
    with open(bgz, "rb") as fh:
        blocks = walk(fh.read())[0][: -1 if spec["eof_block"] else None]
    write_gzi(bgz + ".gzi", [(b[0], n * spec["block_payload"])
                             for n, b in enumerate(blocks)])
    return out


def write_gzi(path: str, offsets: List[Tuple[int, int]]) -> None:
    """The `.gzi` of blocks at ``offsets`` (compressed, uncompressed): the
    count, then every block's pair but the first's."""
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", max(len(offsets) - 1, 0)))
        fh.write(b"".join(_GZI.pack(*o) for o in offsets[1:]))


def read_gzi(path: str) -> Optional[List[Tuple[int, int]]]:
    """The pairs of the `.gzi` at ``path``; None where it is missing or cut."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return None
    if len(data) < 8:
        return None
    (count,) = struct.unpack_from("<Q", data)
    if len(data) != 8 + count * _GZI.size:
        return None
    return [_GZI.unpack_from(data, 8 + j * _GZI.size) for j in range(count)]


def walk(data: bytes) -> Tuple[List[Tuple[int, int, int]], int]:
    """The blocks of a BGZF file's bytes by their headers, the EOF block
    among them: [(offset, header bytes, BSIZE)], and 1 where the walk had to
    stop at a header that is no BGZF header or a block that runs past the
    end (else 0)."""
    blocks, at = [], 0
    while at < len(data):
        if len(data) - at < 18 or data[at: at + 4] != b"\x1f\x8b\x08\x04":
            return blocks, 1
        (xlen,) = struct.unpack_from("<H", data, at + 10)
        if at + 12 + xlen > len(data):
            return blocks, 1
        bsize, sub = None, at + 12
        while sub + 4 <= at + 12 + xlen:
            slen = struct.unpack_from("<H", data, sub + 2)[0]
            if data[sub: sub + 2] == b"BC" and slen == 2:
                bsize = struct.unpack_from("<H", data, sub + 4)[0] + 1
            sub += 4 + slen
        if bsize is None or bsize < 12 + xlen + 8 or at + bsize > len(data):
            return blocks, 1
        blocks.append((at, 12 + xlen, bsize))
        at += bsize
    return blocks, 0


def _block(data: bytes, block: Tuple[int, int, int], payload_max: int, level: int,
           sampled: bool) -> Tuple[bytes, int, int]:
    """(a block's inflated payload, its wrong fields, 1 where it is sampled
    and its deflated bytes are not the standard library's at ``level``)."""
    at, header, bsize = block
    cdata = memoryview(data)[at + header: at + bsize - 8]
    crc, isize = struct.unpack_from("<2I", data, at + bsize - 8)
    inflater = zlib.decompressobj(-15)
    try:
        payload = inflater.decompress(cdata)
        ends_at_bsize = inflater.eof and not inflater.unused_data
    except zlib.error:
        payload, ends_at_bsize = b"", False
    wrong = (not ends_at_bsize) + (zlib.crc32(payload) != crc) + (len(payload) != isize) \
        + (len(payload) > payload_max)
    unequal = 0
    if sampled and payload:
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        unequal = int(cdata != co.compress(payload) + co.flush())
    return payload, wrong, unequal


def sampled_blocks(seed: int, n_blocks: int) -> set:
    """One block in ``SAMPLE_EVERY`` of ``n_blocks``, chosen from the seed."""
    rng = np.random.default_rng(genome.seed_sequence(seed, 4))
    return set(rng.choice(n_blocks, size=-(-n_blocks // SAMPLE_EVERY), replace=False).tolist())


def judge_bgz(kin: str, spec: Dict, sample: set) -> Dict[str, int]:
    """The `.kin.bgz` and `.gzi` beside ``kin`` against its bytes: the three
    numbers of the check, and the `.kin.bgz`'s size."""
    plane = np.fromfile(kin, dtype=np.uint8)
    try:
        with open(kin + ".bgz", "rb") as fh:
            data = fh.read()
    except OSError:
        return {"bytes": plane.shape[0], "fields": 1, "unequal": 0, "size": 0}
    blocks, fields = walk(data)
    if blocks and data[blocks[-1][0]: blocks[-1][0] + blocks[-1][2]] == index_bgzf.EOF_BLOCK:
        blocks.pop()
    else:
        fields += 1  # no EOF block
    wrong = unequal = 0
    at = 0  # the next payload's offset in the .kin
    offsets = []
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for lo in range(0, len(blocks), BLOCKS_A_BATCH):
            part = range(lo, min(lo + BLOCKS_A_BATCH, len(blocks)))
            judged = pool.map(lambda b: _block(data, blocks[b], spec["block_payload"],
                                               spec["level"], b in sample), part)
            for b, (payload, bad, other) in zip(part, judged):
                offsets.append((blocks[b][0], at))
                got = np.frombuffer(payload, dtype=np.uint8)
                want = plane[at: at + got.shape[0]]
                wrong += int(np.count_nonzero(got[: want.shape[0]] != want))
                fields += bad
                unequal += other
                at += got.shape[0]
    wrong += abs(plane.shape[0] - at)
    gzi = read_gzi(kin + ".bgz.gzi")
    if gzi is None:
        fields += max(len(offsets) - 1, 1)
    else:
        fields += sum(a != tuple(b) for a, b in zip(offsets[1:], gzi)) \
            + abs(len(offsets) - 1 - len(gzi))
    return {"bytes": wrong, "fields": fields, "unequal": unequal, "size": len(data)}


def check(run) -> Dict[str, Tuple[float, float]]:
    checks = index_bgzf.check(run)
    spec = run.config["output"]
    done = run.completed
    totals = {"bytes": 0, "fields": 0, "unequal": 0}
    wrong_jobs, sizes = 0, []
    sample = sampled_blocks(run.seed, -(-4 ** run.config["kmer_len"] // spec["block_payload"]))
    for job in done:
        judged = judge_bgz(job.result["kin"], spec, sample)
        for key in totals:
            totals[key] += judged[key]
        wrong_jobs += bool(judged["bytes"] or judged["fields"] or judged["unequal"])
        sizes.append(judged["size"])
    run.state["jobs_wrong"] = min(len(done), run.state.get("jobs_wrong", 0) + wrong_jobs)
    run.state["info"].update(bgz_bytes=sizes, bgz_blocks_sampled=len(sample),
                             bgz_ratio=4 ** run.config["kmer_len"] / sizes[0]
                             if sizes and sizes[0] else None)
    checks.update(bgz_bytes_wrong=(totals["bytes"], LIMITS["bgz_bytes_wrong"]),
                  bgz_fields_wrong=(totals["fields"], LIMITS["bgz_fields_wrong"]),
                  bgz_blocks_unequal=(totals["unequal"], LIMITS["bgz_blocks_unequal"]))
    return checks
