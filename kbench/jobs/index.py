"""Job kind ``index``: one genome indexed again and again by
``pykmer_tpu_torch.create_fasta_index``, as a user indexes an assembly.

Set-up writes the configuration's genome from the seed and runs one warm
index at the same K: of a smaller genome of ``warm_bp`` bases made alike,
or of the genome itself where ``warm_bp`` is 0. Each call of the window
indexes the genome under a name of its own (a link to the one file), so
every `.kin` the window wrote is still there to judge: deleting a 1 GiB
`.kin` between calls takes 0.2-0.3 s of the window. The check counts the
genome with the plain reference and compares every call's `.kin.json` (its
sha256 of the `.kin` among them), and the `.kin` bytes of
``check_kin_files`` calls, a sample drawn from the seed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from kbench import genome
from kbench.reference import index as ref

# exact comparisons: the worst sampled `.kin`'s wrong cells, and the wrong
# `.kin.json` fields summed over every call
LIMITS = {"kin_bytes_wrong": 0, "meta_fields_wrong": 0}


def _index_config(run, kmer_len: int):
    from pykmer_tpu_torch.config import IndexConfig

    return IndexConfig(kmer_len=kmer_len, readback=run.workload["readback"])


def setup(run) -> None:
    from pykmer_tpu_torch import create_fasta_index

    cfg, wl = run.config, run.workload
    k = cfg["kmer_len"]
    fasta = os.path.join(run.directory, "genome.fa")
    t0 = time.perf_counter()
    spec = genome.spec(cfg)
    run.state["records"] = genome.make_genome(fasta, run.seed, **spec)
    run.state["bases"] = genome.genome_bases(run.state["records"])
    run.state["fasta"] = fasta
    _sync(fasta)
    t1 = time.perf_counter()
    warm = os.path.join(run.directory, "warm.fa")
    if wl["warm_bp"]:
        genome.make_genome(warm, run.seed + 1, **dict(
            spec, genome_bp=wl["warm_bp"], records=1,
            n_bases=spec["n_bases"] * wl["warm_bp"] // spec["genome_bp"]))
    else:
        os.symlink(fasta, warm)
    create_fasta_index(warm, "warm", warm, k, config=_index_config(run, k),
                       verify=wl["verify"], verbose=False, device=run.device)
    run.state["info"] = {"setup_inputs_s": t1 - t0, "setup_warm_s": time.perf_counter() - t1}
    for name in os.listdir(run.directory):
        if name.startswith("warm.fa"):
            _remove(run, os.path.join(run.directory, name))


def _remove(run, path: str) -> None:
    run.state["removed_bytes"] = run.state.get("removed_bytes", 0) + os.lstat(path).st_size
    os.remove(path)


def _sync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def call(run, i: int) -> Dict:
    from pykmer_tpu_torch import create_fasta_index

    k = run.config["kmer_len"]
    link = os.path.join(run.directory, f"g{i:03d}.fa")
    os.symlink(run.state["fasta"], link)
    create_fasta_index(link, f"g{i:03d}", link, k, config=_index_config(run, k),
                       verify=run.workload["verify"], verbose=False, device=run.device)
    return {"bases": run.state["bases"], "kin": f"{link}.{k:02d}.kin"}


def end_to_end(run) -> Dict[str, float]:
    done = run.completed
    return {"index_bp_per_s": sum(j.result["bases"] for j in done) / run.window_s} \
        if done else {}


def reference(run, cells=ref.saturate) -> Tuple:
    """(the plane on the run's device, the expected `.kin.json` fields) of
    the genome; ``cells`` turns the counts into the plane. Records the work
    counts the roofline shares read."""
    k = run.config["kmer_len"]
    counts, n_windows, chromosomes = ref.count_records(run.state["records"], k, run.device)
    plane = cells(counts)
    del counts
    run.work.update(bases=run.state["bases"], valid_windows=n_windows, kmer_len=k,
                    distinct_cells=int(torch.count_nonzero(plane)))
    expected = ref.expected_metadata(plane, n_windows, chromosomes, k,
                                     ref.sha256_file(run.state["fasta"]))
    return plane, expected


def control(run, i: int) -> Dict:
    """The control in the program's place: the reference with the
    saturation at 255 broken (counts wrap at 256), its `.kin` and
    `.kin.json` written where a call writes them."""
    k = run.config["kmer_len"]
    plane, meta = reference(run, cells=lambda counts: (counts % 256).to(torch.uint8))
    kin = os.path.join(run.directory, f"g{i:03d}.fa.{k:02d}.kin")
    plane.cpu().numpy().tofile(kin)
    with open(kin + ".json", "w") as fh:
        json.dump(meta, fh)
    return {"bases": run.state["bases"], "kin": kin}


def _meta(path: str) -> Dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def check(run) -> Dict[str, Tuple[float, float]]:
    plane, expected = reference(run)
    done = run.completed
    picks = np.random.default_rng(genome.seed_sequence(run.seed, 3)).permutation(len(done))
    sampled = {done[p].index for p in picks[: run.workload["check_kin_files"]]}
    bytes_wrong, fields_wrong, wrong_jobs = 0, 0, 0
    for job in done:
        bad = ref.fields_wrong(_meta(job.result["kin"] + ".json"), expected)
        cells = ref.bytes_wrong(job.result["kin"], plane) if job.index in sampled else 0
        bytes_wrong = max(bytes_wrong, cells)
        fields_wrong += len(bad)
        wrong_jobs += bool(bad or cells)
    run.state["jobs_wrong"] = wrong_jobs
    run.state["info"].update(kin_files_compared=len(sampled),
                             valid_windows=run.work["valid_windows"],
                             distinct_cells=run.work["distinct_cells"])
    return {"kin_bytes_wrong": (bytes_wrong, LIMITS["kin_bytes_wrong"]),
            "meta_fields_wrong": (fields_wrong, LIMITS["meta_fields_wrong"])}
