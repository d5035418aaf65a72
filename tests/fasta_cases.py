"""FASTA byte strings that probe the decoder's semantics, shared by the CPU
tests of the plain card decode (test_torch_fasta_decode.py) and the card
tests of its kernel (test_torch_cuda.py). Imports neither jax nor either
package; each case is built from a fixed seed."""

import numpy as np

TEN_MBP = 10_000_000


def _seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=n))


def _lines(seq, width):
    return "".join(seq[i : i + width] + "\n" for i in range(0, len(seq), width))


def _crlf(rng):
    return "".join(f">r{i} crlf\r\n" + _lines(_seq(rng, 300 + 7 * i), 60).replace("\n", "\r\n")
                   for i in range(4)).encode()


def _lower(rng):
    return (">upper\n" + _lines(_seq(rng, 500), 70) + ">lower\n"
            + _lines(_seq(rng, 500, "acgt"), 70) + ">mixed\n"
            + _lines(_seq(rng, 500, "ACGTacgt"), 33)).encode()


def _iupac(rng):
    return (">iupac\n" + _lines(_seq(rng, 900, "ACGTRYKMSWBDHVNacgtrykmswbdhvn"), 50)
            + ">n_runs\n" + _lines(_seq(rng, 200) + "N" * 40 + _seq(rng, 300) + "n" * 17
                                   + _seq(rng, 30), 61)).encode()


def _interior_space(rng):
    out = [">spaced  name\t\n"]
    for _ in range(40):
        s = _seq(rng, 40)
        cut = sorted(rng.integers(1, 39, size=3))
        out.append(f"{s[:cut[0]]} {s[cut[0]:cut[1]]}\t\t{s[cut[1]:cut[2]]}\x0b\x0c{s[cut[2]:]}\n")
    out.append(">two\n  ACGTACGTAC  GT \t\n\tTTTTGGGGCC\r\n")
    return "".join(out).encode()


def _blank_lines(rng):
    return ("\n\n>a\n\n" + _lines(_seq(rng, 200), 40) + "\n   \n\t\r\n"
            + _lines(_seq(rng, 200), 40) + "\n\n>b\n \n" + _lines(_seq(rng, 90), 30)
            + "\n\n").encode()


def _before_first_header(rng):
    return ("stray ACGT text\n" + _seq(rng, 100) + "\n  \n>first\n"
            + _lines(_seq(rng, 400), 80)).encode()


def _gt_in_sequence(rng):
    s = _seq(rng, 600)
    return (">a\n" + s[:100] + ">" + s[100:200] + "\n ACGT>ACGT\n" + _lines(s[200:], 80)
            + "  >b header after spaces\n" + _lines(_seq(rng, 150), 50)).encode()


def _empty_record(rng):
    return (">empty1\n>full\n" + _lines(_seq(rng, 300), 60) + ">empty2\n\n  \n>empty3\n"
            + ">last\n" + _lines(_seq(rng, 120), 60)).encode()


def _shorter_than_k(rng):
    return (">tiny\nACG\n>short\nACGTACGTACGTAC\n>ok\n" + _lines(_seq(rng, 200), 50)
            + ">tiny_end\nA\n").encode()


def _all_n(rng):
    return (">alln\n" + _lines("N" * 500, 60) + ">after\n" + _lines(_seq(rng, 200), 60)
            + ">alln_lower\n" + "n" * 90 + "\n").encode()


def _single_line_10mbp(rng):
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=TEN_MBP)]
    seq[rng.integers(0, TEN_MBP, size=1000)] = ord("N")
    return (b">long single line\n" + seq.tobytes() + b"\n>next\n"
            + _lines(_seq(rng, 1000), 80).encode())


def _width_1(rng):
    return (">w1\n" + _lines(_seq(rng, 700), 1) + ">w1b\n" + _lines(_seq(rng, 33, "ACGTN"), 1)
            ).encode()


def _no_final_newline(rng):
    return (">a\n" + _lines(_seq(rng, 300), 70) + ">b\n" + _seq(rng, 95) + "  ").encode()


def _nul_and_high_bytes(rng):
    s = np.frombuffer(_seq(rng, 800).encode(), np.uint8).copy()
    s[rng.integers(0, 800, size=30)] = 0
    s[rng.integers(0, 800, size=30)] = rng.integers(0x80, 0x100, size=30).astype(np.uint8)
    body = b"\n".join(s[i : i + 80].tobytes() for i in range(0, 800, 80))
    return b">name \xc3\xa9\x00x\n" + body + b"\n>\xff\xfe\n" + b"\x00ACGT\x80\n"


def _fuzz(seed):
    def make(rng):
        # bytes of the decoder's every class, runs and lines of every length
        pool = np.frombuffer(b"ACGTacgtNn>\n\n \t\r\x0b\x0cRY\x00\xff", np.uint8)
        weights = np.array([8, 8, 8, 8, 2, 2, 2, 2, 2, 1, 0.4, 1, 1, 1, 0.5, 0.5, 0.2, 0.2,
                            0.5, 0.5, 0.2, 0.2])
        rng = np.random.default_rng(seed)
        n = int(rng.integers(50_000, 400_000))
        out = pool[rng.choice(pool.shape[0], size=n, p=weights / weights.sum())]
        # a few long lines and long runs of spaces
        for _ in range(5):
            at, ln = int(rng.integers(0, n - 5000)), int(rng.integers(300, 5000))
            out[at : at + ln] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=ln)]
        at = int(rng.integers(0, n - 3000))
        out[at : at + 3000] = ord(" ")
        return b">start\n" + out.tobytes()
    return make


CASES = {
    "crlf": _crlf,
    "lower_case": _lower,
    "iupac_and_n": _iupac,
    "interior_whitespace": _interior_space,
    "blank_lines": _blank_lines,
    "text_before_first_header": _before_first_header,
    "gt_inside_a_sequence_line": _gt_in_sequence,
    "empty_record": _empty_record,
    "record_shorter_than_k": _shorter_than_k,
    "all_n_record": _all_n,
    "single_line_10mbp": _single_line_10mbp,
    "lines_of_width_1": _width_1,
    "no_final_newline": _no_final_newline,
    "nul_and_non_ascii": _nul_and_high_bytes,
    "empty_input": lambda rng: b"",
    "no_header": lambda rng: b"ACGT\nACGT\n",
    "fuzz_1": _fuzz(1),
    "fuzz_2": _fuzz(2),
    "fuzz_3": _fuzz(3),
}


def case_bytes(name: str) -> bytes:
    return CASES[name](np.random.default_rng(sorted(CASES).index(name)))
