#!/usr/bin/env python3
"""Time the encode kernels against their earlier design on one NVIDIA GPU.

Run from the root of a checkout:  python3 scripts/bench_encode_variants.py

Builds the port's kernels (``pykmer_tpu_torch/csrc``) and
``scripts/encode_variants.cu`` (the earlier design: 64-bit window
arithmetic at every K, byte staging, the bases entry repacked by a serial
loop over shared memory) with nvcc for sm_90a, then at the main path's
chunk size (2^24 windows, the planes of ``chip_smoke.encode_planes``: ~1%
invalid bases and a run of 1000) checks every variant with ``torch.equal``
against the plain torch encoder, and the fused valid-window count against
the plain count, and times each (the median of 20 launches by CUDA events
with a ~1 ms spin queued ahead, in two rounds, the second in the reverse
order): the packed entry at K=15 and K=17, masked and all-valid, with and
without the count, and the earlier kernel followed by the separate count
pass that step A ran before; the bases entry at K=15, 17 and 19. Each time
is printed beside its byte bound (the planes read once, the codes written
once, at 3.35 TB/s). Where ``cuobjdump`` is present, the SASS instructions
of each encode kernel are counted, in all and on the hot path (from the
barrier that ends the staging to the last code store, less the ragged-end
branch), the latter divided by the windows a thread encodes. The card's name and power limit come first; the last line is a
JSON object of every number.
"""

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "scripts", "encode_variants.cu")
PACKED_K = (15, 17)
BASES_K = (15, 17, 19)
REPS = 20
# windows a thread encodes: the port's kernels, the earlier design's
WINDOWS_PER_THREAD = {"port": 16, "earlier design": 8}


def start_build():
    """Start nvcc on ``encode_variants.cu`` unless its library is built;
    returns (library path, the nvcc process or None)."""
    sys.path.insert(0, ROOT)
    from pykmer_tpu_torch.ops import _build

    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    so = os.path.join(_build.BUILD_DIR, f"libencode_variants_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so, None
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{so}.tmp", SRC],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return so, proc


def finish_build(handle):
    """The variants' library once its build has ended; raises with nvcc's
    output if it failed."""
    so, proc = handle
    if proc is not None:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SRC} ({proc.returncode}):\n{out}")
        os.replace(f"{so}.tmp", so)
    lib = ctypes.CDLL(so)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for stem, argtypes in (("strided64_encode_packed", [ptr, i64, ptr, i64, i64, i64, ptr, ptr]),
                           ("strided64_encode_bases", [ptr, i64, i64, ptr, ptr])):
        for suffix in ("_i32", "_i64"):
            fn = getattr(lib, stem + suffix)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def sass_counts(so):
    """{kernel: (SASS instructions, hot-path instructions)} of the encode
    kernels in the library ``so`` (NOPs left out), or None where
    ``cuobjdump`` is absent. The hot path runs from the last barrier before
    the first code store to the last code store, less the ragged-end blocks
    that a branch to a 16-byte store skips: what a thread of a full block
    executes to encode its windows."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = []
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if name and ins and not ins.group(2).strip().startswith("NOP"):
            funcs[name].append((int(ins.group(1), 16), ins.group(2).strip()))
    out = {}
    for name, ins in funcs.items():
        m = re.search(r"(encode_(?:packed|bases)_kernel)I([il])(Lb[01])?", name)
        if not m:
            continue
        label = m.group(1) + ("_i32" if m.group(2) == "i" else "_i64") + \
            {"Lb1": "_masked", "Lb0": "_all_valid", None: ""}[m.group(3)]
        stores = [i for i, (_, t) in enumerate(ins) if t.startswith(("STG", "@"))
                  and "STG" in t]
        bar = max(i for i, (_, t) in enumerate(ins[: stores[0]]) if "BAR.SYNC" in t)
        vector = {a for a, t in ins if "STG.E.128" in t}
        index = {a: i for i, (a, _) in enumerate(ins)}
        hot, i = 0, bar + 1
        while i <= stores[-1]:
            hot += 1
            jump = re.search(r"BRA\s+(?:\S+,\s*)?0x([0-9a-f]+)", ins[i][1])
            target = int(jump.group(1), 16) if jump else -1
            i = index[target] if target in vector and target > ins[i][0] else i + 1
        out[label] = (len(ins), hot)
    return out


def log_sass(counts, log):
    for which, by_kernel in counts.items():
        if by_kernel is None:
            log(f"SASS {which}: cuobjdump absent, not counted")
            continue
        w = WINDOWS_PER_THREAD[which]
        for name, (n, hot) in by_kernel.items():
            log(f"SASS {which} {name}: {n} instructions, {hot} on the hot path for {w} "
                f"windows a thread = {hot / w:.1f} a window")


def compare(dev, log, vlib):
    """Every variant against the plain encoder and timed, as the module
    says; returns {case: {"bound_ms", "ms": {variant: [round 1, round 2]}}}."""
    import torch

    import chip_smoke as cs
    from pykmer_tpu_torch.ops import _build, encode

    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    cases = {}
    for k in sorted(set(PACKED_K) | set(BASES_K)):
        span, bases2, maskbits, chunk, clean = cs.encode_planes(dev, k, gen)
        m = span - k + 1
        dt = encode.code_dtype(k)
        sfx = "_i32" if dt == torch.int32 else "_i64"
        out = torch.empty(m, dtype=dt, device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        fold = 4**k // 2
        variants = {}

        def call(fn, *args):
            err = fn(*args, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError_t {err}")

        for variant, mb in (("masked", maskbits), ("all-valid", None)):
            if k not in PACKED_K:
                continue
            args = (bases2.data_ptr(), bases2.numel(), None if mb is None else mb.data_ptr(),
                    0 if mb is None else mb.numel(), m, k, out.data_ptr())
            new, old = (getattr(lib, "pykmer_encode_packed" + sfx),
                        getattr(vlib, "strided64_encode_packed" + sfx))
            fns = variants[(f"packed K={k} {variant}", m * out.element_size()
                            + bases2.numel() + (0 if mb is None else mb.numel()))] = {
                "fused count": lambda new=new, args=args: call(new, *args, count.data_ptr()),
                "no count": lambda new=new, args=args: call(new, *args, None),
                "earlier design": lambda old=old, args=args: call(old, *args),
                "earlier design + count pass": lambda old=old, args=args: (
                    call(old, *args), count.add_((out < fold).sum(dtype=torch.int64))),
            }
            want = encode.canonical_codes_packed_plain(bases2, mb, span, k)
            want_count = int((want < fold).sum())
            for name, fn in fns.items():
                out.fill_(-1)
                count.zero_()
                fn()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"packed K={k} {variant}: {name} differs from the "
                                         f"plain encoder")
                if name in ("fused count", "earlier design + count pass") \
                        and int(count) != want_count:
                    raise AssertionError(f"packed K={k} {variant}: {name} counted "
                                         f"{int(count)} valid windows, the plain count is "
                                         f"{want_count}")
            del want
        for variant, c in (("masked", chunk), ("all-valid", clean)):
            if k not in BASES_K:
                continue
            new, old = (getattr(lib, "pykmer_encode_bases" + sfx),
                        getattr(vlib, "strided64_encode_bases" + sfx))
            args = (c.data_ptr(), c.numel(), k, out.data_ptr())
            fns = variants[(f"bases K={k} {variant}", m * out.element_size() + c.numel())] = {
                "register packing": lambda new=new, args=args: call(new, *args),
                "earlier design": lambda old=old, args=args: call(old, *args),
            }
            want = encode.canonical_codes_plain(c, k)
            for name, fn in fns.items():
                out.fill_(-1)
                fn()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"bases K={k} {variant}: {name} differs from the "
                                         f"plain encoder")
            del want
        for (label, moved), fns in variants.items():
            bound = moved / cs.H100_SXM_BYTES_PER_S * 1e3
            times = {name: [] for name in fns}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    times[name].append(cs.median_ms(fns[name], REPS))
            log(f"{label}: every variant equal to the plain encoder; bound {bound:.4f} ms "
                f"({moved} bytes)")
            for name, t in times.items():
                log(f"  {name:28s} {t} ms -> best {min(t):.4f} ms, share of bound "
                    f"{bound / min(t):.3f}")
            cases[label] = {"bound_ms": bound, "ms": times}
        del bases2, maskbits, chunk, clean, out
        torch.cuda.empty_cache()
    return cases


def main():
    import torch

    if not torch.cuda.is_available():
        print("bench_encode_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pykmer_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    handle = start_build()
    port = _build.load()
    vlib = finish_build(handle)
    result = {"sass": {"port": sass_counts(port._name), "earlier design": sass_counts(handle[0])}}
    log_sass(result["sass"], lambda s: print(s, flush=True))
    result["cases"] = compare(torch.device("cuda"), lambda s: print(s, flush=True), vlib)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
