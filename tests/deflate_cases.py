"""Payloads for the tests of the card deflate and its plain version, each
reaching a rule that zlib level 6's bytes depend on. No jax here: the card
tests import it.

:func:`case` builds one by name (:data:`NAMES`); the same name gives the
same bytes.
"""

import functools

import numpy as np

BLOCK = 65280  # bgzip's payload


def _random(rng, n, lo=0, hi=256):
    return bytearray(rng.integers(lo, hi, n, dtype=np.uint8).tobytes())


def _head_across_max_dist(dist):
    """A 12-byte string seen once before, ``dist`` back: zlib searches only
    where the chain's head lies within MAX_DIST (32,506)."""
    rng = np.random.default_rng(dist)
    payload = _random(rng, dist + 500, 0, 200)
    marker = _random(rng, 12, 200, 256)
    payload[100:112] = marker
    payload[100 + dist: 112 + dist] = marker
    return payload


def _chain_across_max_dist(dist):
    """The head is a 3-byte match 50 back; the 12-byte match ``dist`` back
    is the chain's next candidate, taken only while it lies within
    MAX_DIST - 1 (``cur_match > limit``)."""
    rng = np.random.default_rng(dist + 1)
    payload = _random(rng, dist + 500, 0, 200)
    marker = _random(rng, 12, 200, 256)
    payload[100:112] = marker
    payload[50 + dist: 53 + dist] = marker[:3]
    payload[100 + dist: 112 + dist] = marker
    return payload


def _too_far(dist):
    """A 3-byte match ``dist`` back: dropped farther than 4,096."""
    rng = np.random.default_rng(dist)
    payload = _random(rng, dist + 300, 0, 200)
    payload[100:104] = bytes([201, 202, 203, 204])
    payload[100 + dist: 104 + dist] = bytes([201, 202, 203, 205])
    return payload


def _last_byte(length, zeros):
    """The payload ends inside a repeat of an earlier piece, or a zero run,
    ``length`` long: lengths are held to the bytes left."""
    rng = np.random.default_rng(length)
    head = _random(rng, 2000)
    return head + (bytes(length) if zeros else head[500: 500 + length])


def last_block_empty():
    """A random run, then a copy of 10 of its bytes, so long that the
    16,383rd symbol is that copy, which ends on the payload's last byte:
    the flush leaves the final block empty."""
    from pykmer_tpu_torch.ops import deflate

    rng = np.random.default_rng(12)
    head = _random(rng, 16500)
    for n in range(16370, 16400):
        payload = bytes(head[:n] + head[1000:1010])
        blocks = list(deflate.parse(np.frombuffer(payload, dtype=np.uint8)))
        if len(blocks) == 2 and not blocks[1][2]:
            return payload
    raise AssertionError("no payload ends a block on its last byte")


def _positions(payload):
    """The parse's symbols, each as (its first position, 0 for a literal
    or its length)."""
    from pykmer_tpu_torch.ops import deflate

    at, out = 0, []
    for _, _, syms, _, _ in deflate.parse(np.frombuffer(payload, dtype=np.uint8)):
        for dist, lc in syms:
            out.append((at, lc + 3 if dist else 0))
            at += lc + 3 if dist else 1
    return out


def slid_head(p):
    """A 6-byte marker at ``p - 32,506`` and again at ``p`` (the first
    MAX_DIST back), every other byte from 0-199 and no other position of
    the marker's 3-byte hash between them. zlib slides its window at the
    first step of the parse at 65,274 or past it, which turns a head of
    32,768 into NIL: at 65,274 it does not search, though the marker lies
    within MAX_DIST; at 65,273 (before the slide) and 65,275 (a head past
    32,768) it does. The seed is searched until that is so, and at 65,274
    until the parse takes the bytes at 65,273 and 65,274 as literals, so
    that a step starts there with no match pending: a search there would
    take the marker."""
    from pykmer_tpu_torch.ops import deflate

    for seed in range(200):
        rng = np.random.default_rng([p, seed])
        payload = _random(rng, BLOCK, 0, 200)
        marker = _random(rng, 6, 200, 256)
        payload[p - 32506: p - 32500] = marker
        payload[p: p + 6] = marker[: BLOCK - p]
        if deflate.hash_chains(np.frombuffer(bytes(payload), dtype=np.uint8))[p] != p - 32506:
            continue
        if p != deflate.SLIDE_AT:
            return payload
        literals = {at for at, length in _positions(bytes(payload)) if length == 0}
        if {p - 1, p} <= literals:
            return payload
    raise AssertionError(f"no seed puts a search step at {p} with the marker as its head")


def code_over_its_limit():
    """Copies of Fibonacci-counted lengths out of the last 2,000 bytes: the
    code-length code of the first block wants more than its 7 bits."""
    rng = np.random.default_rng(2)
    out = list(rng.integers(0, 256, 512))
    lens = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51]
    counts = [1, 1]
    while len(counts) < len(lens):
        counts.append(counts[-1] + counts[-2])
    order = [n for n, c in zip(lens, counts[::-1]) for _ in range(c)]
    rng.shuffle(order)
    for n in order:
        at = int(rng.integers(max(0, len(out) - 2000), len(out) - n))
        out.extend(out[at: at + n])
        if len(out) > BLOCK:
            break
    return bytes(np.array(out[:BLOCK], dtype=np.uint8))


def _whole(kind):
    rng = np.random.default_rng(7)
    if kind == "zeros":
        return bytes(BLOCK)
    if kind == "random":  # incompressible: stored blocks of 16,383 bytes
        return _random(rng, BLOCK)
    if kind == "two-bit":  # a .kin's low counts
        return (rng.integers(0, 4, BLOCK) * (rng.random(BLOCK) < 0.4)).astype(np.uint8)
    if kind == "skewed":
        return np.minimum(rng.geometric(0.3, BLOCK), 255).astype(np.uint8)
    if kind == "sixteen":  # more than 16,383 symbols: several dynamic blocks
        return np.random.default_rng(11).integers(0, 16, BLOCK, dtype=np.uint8)
    if kind == "text":
        return (b"the quick brown fox jumps over the lazy dog " * 1500)[:BLOCK]
    rng = np.random.default_rng(3)  # a zero run across MAX_DIST
    payload = _random(rng, 100) + bytes(40000) + _random(rng, 100) + bytes(3) \
        + _random(rng, 20000)
    payload[-200:-197] = b"\x00\x00\x00"
    return payload


_BUILDERS = {
    **{name: (lambda p=p: p) for name, p in (("empty", b""), ("one", b"\x07"), ("two", b"ab"),
                                            ("three", b"abc"), ("three-same", b"aaa"),
                                            ("six", b"abcabc"))},
    **{kind: functools.partial(_whole, kind)
       for kind in ("zeros", "random", "two-bit", "skewed", "sixteen", "text", "long-run")},
    **{f"head-at-{d}": functools.partial(_head_across_max_dist, d)
       for d in (32504, 32505, 32506, 32507, 32508)},
    **{f"chain-at-{d}": functools.partial(_chain_across_max_dist, d)
       for d in (32504, 32505, 32506, 32507)},
    **{f"too-far-{d}": functools.partial(_too_far, d) for d in (4095, 4096, 4097)},
    **{f"ends-in-copy-{n}": functools.partial(_last_byte, n, False)
       for n in (1, 2, 3, 4, 5, 15, 16, 17, 127, 128, 129, 257, 258, 259, 300)},
    **{f"ends-in-zeros-{n}": functools.partial(_last_byte, n, True)
       for n in (1, 2, 3, 4, 5, 17, 128, 129, 258, 259)},
    **{f"slid-head-{p}": functools.partial(slid_head, p) for p in (65273, 65274, 65275)},
    "last-block-empty": last_block_empty,
    "code-over-its-limit": code_over_its_limit,
}
NAMES = sorted(_BUILDERS)


@functools.lru_cache(maxsize=None)
def case(name: str) -> bytes:
    return bytes(_BUILDERS[name]())
