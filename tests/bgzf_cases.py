"""BGZF blocks in every DEFLATE form, written with the standard library's
zlib, for the tests of the inflates (the host pool's and the card's).

A case is a list of (payload, deflated) pairs, one a BGZF block;
:func:`bgzf_bytes` lays them out as ``bgzip`` does, each block a gzip member
with the ``BC`` subfield and its CRC32 and ISIZE. No jax here: the card
tests import it.
"""

import functools
import random
import struct
import zlib

EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
BLOCK = 65280  # bgzip's payload


def member(payload: bytes, deflated: bytes) -> bytes:
    """One BGZF block: ``deflated`` (raw DEFLATE of ``payload``) in a gzip
    member with the ``BC`` subfield, its CRC32 and ISIZE."""
    bsize = 18 + len(deflated) + 8
    return (struct.pack("<4BI2BH2BHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 0x42, 0x43, 2,
                        bsize - 1)
            + deflated + struct.pack("<2I", zlib.crc32(payload), len(payload)))


def deflate(payload: bytes, level: int = 6, strategy: int = zlib.Z_DEFAULT_STRATEGY,
            flushes: int = 0) -> bytes:
    """Raw DEFLATE of ``payload``; ``flushes`` full flushes inside it end
    as many DEFLATE blocks early."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    if not flushes:
        return co.compress(payload) + co.flush()
    out = b""
    step = max(1, len(payload) // (flushes + 1))
    for i in range(0, len(payload), step):
        out += co.compress(payload[i:i + step]) + co.flush(zlib.Z_FULL_FLUSH)
    return out + co.flush()


def bgzf_bytes(blocks, eof: bool = True) -> bytes:
    return b"".join(member(p, d) for p, d in blocks) + (EOF_BLOCK if eof else b"")


def genome(n: int, seed: int) -> bytes:
    """``n`` bases of A/C/G/T with copied stretches, as an assembly's repeats."""
    rng = random.Random(seed)
    s = bytearray(rng.choice(b"ACGT") for _ in range(n))
    for _ in range(n // 500):
        a, b, length = rng.randrange(n), rng.randrange(n), rng.randrange(5, 300)
        s[b:b + length] = s[a:a + length]
    return bytes(s[:n])


@functools.lru_cache(maxsize=None)
def cases():
    """{name: blocks}, built once and not to be changed: stored (level 0,
    and random bytes), fixed, dynamic at levels 1, 6 and 9, Huffman-only and
    RLE, several DEFLATE blocks in one BGZF block, an empty block, distance-1
    runs of 258-byte matches, 32 KiB distances, and FASTA text in blocks of
    every level."""
    g = genome(BLOCK, 1)
    rnd = random.Random(2).randbytes(BLOCK)
    far = random.Random(3).randbytes(32768)
    far = (far + far)[:BLOCK]
    text = b"".join(b">rec%d some text\n" % i + genome(200 + 13 * i, i) + b"\n"
                    for i in range(60))[:BLOCK]
    out = {f"dynamic_level{lv}": [(g, deflate(g, lv))] for lv in (1, 6, 9)}
    out.update({
        "stored_level0": [(g, deflate(g, 0))],
        "stored_random": [(rnd, deflate(rnd, 6))],
        "fixed": [(g[:3000], deflate(g[:3000], 6, zlib.Z_FIXED))],
        "huffman_only": [(g, deflate(g, 6, zlib.Z_HUFFMAN_ONLY))],
        "rle": [(g, deflate(g, 6, zlib.Z_RLE))],
        "multi_block": [(g, deflate(g, 6, flushes=7))],
        "empty": [(b"", deflate(b""))],
        "distance1_length258": [(b"A" * BLOCK, deflate(b"A" * BLOCK, 9))],
        "distance_32k": [(far, deflate(far, 9))],
        "fasta_mixed": [(text[i:i + 4000], deflate(text[i:i + 4000], lv))
                        for i, lv in zip(range(0, BLOCK, 4000), [1, 6, 9, 0] * 5)],
    })
    return out


def walk(data: bytes):
    """(c_offs, u_offs) of ``data``'s blocks, each with its end sentinel."""
    c, u, pos = [0], [0], 0
    while pos < len(data):
        bsize = struct.unpack_from("<H", data, pos + 16)[0] + 1
        u.append(u[-1] + struct.unpack_from("<I", data, pos + bsize - 4)[0])
        pos += bsize
        c.append(pos)
    return c, u


def corrupt(data: bytes, what: str, block: int = 0) -> bytes:
    """``data`` with block ``block`` broken: its CRC (``crc``), its ISIZE one
    less (``isize``), its DEFLATE bytes zeroed (``stream``), or its DEFLATE
    stream cut to half, the block's size following (``truncated``)."""
    c, _ = walk(data)
    pos, end = c[block], c[block + 1]
    out = bytearray(data)
    if what == "crc":
        out[end - 8] ^= 0x01
    elif what == "isize":
        out[end - 4:end] = struct.pack("<I", struct.unpack_from("<I", data, end - 4)[0] - 1)
    elif what == "stream":
        out[pos + 18:end - 8] = bytes(end - 8 - pos - 18)
    else:
        deflated = data[pos + 18:end - 8]
        cut = deflated[: len(deflated) // 2]
        blk = bytearray(data[pos:pos + 18] + cut + data[end - 8:end])
        struct.pack_into("<H", blk, 16, len(blk) - 1)
        out[pos:end] = blk
    return bytes(out)
