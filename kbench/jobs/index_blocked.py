"""Job kind ``index_blocked``: the ``index`` job judged by the blocked plain
reference, for planes too large for ``reference/index.py`` (at K=17 its
int64 counts of the 4^K cells would take 137 GB of the card).

Set-up, each call and the end-to-end rate are ``jobs/index.py``'s own: the
timed path is the same code as the ``index`` cells'. A call also notes which
readback tail its index took (the program's ``index/indexer.TAILS``
counter, read around the call), in the run's info; where the program keeps
no such counter it notes nothing. The check and the control are
``jobs/index.py``'s with ``reference/index_blocked.py`` in place of
``reference/index.py``, under the same limits.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from kbench import genome
from kbench.jobs import index
from kbench.reference import index_blocked as ref
from kbench.reference.index import fields_wrong, sha256_file

LIMITS = index.LIMITS
setup = index.setup
end_to_end = index.end_to_end


def _tails() -> Optional[Dict[str, int]]:
    from pykmer_tpu_torch.index import indexer

    tails = getattr(indexer, "TAILS", None)
    return None if tails is None else dict(tails)


def call(run, i: int) -> Dict:
    before = _tails()
    result = index.call(run, i)
    after = _tails()
    taken = None if after is None else \
        ",".join(t for t in sorted(after) if after[t] != before.get(t, 0))
    run.state["info"].setdefault("tails", []).append(taken)
    return result


def _judge(run, kin_paths=(), write_path=None, cells=ref.saturate_):
    k = run.config["kmer_len"]
    return ref.judge(run.state["records"], k, run.device, sha256_file(run.state["fasta"]),
                     kin_paths=kin_paths, write_path=write_path, cells=cells)


def control(run, i: int) -> Dict:
    """The control in the program's place: the blocked reference with the
    saturation at 255 broken (counts wrap at 256), its `.kin` written block
    by block and its `.kin.json` where a call writes them."""
    k = run.config["kmer_len"]
    kin = os.path.join(run.directory, f"g{i:03d}.fa.{k:02d}.kin")
    meta, _, _ = _judge(run, write_path=kin,
                        cells=lambda counts: counts.remainder_(256).to(torch.uint8))
    with open(kin + ".json", "w") as fh:
        json.dump(meta, fh)
    return {"bases": run.state["bases"], "kin": kin}


def check(run) -> Dict[str, Tuple[float, float]]:
    done = run.completed
    picks = np.random.default_rng(genome.seed_sequence(run.seed, 3)).permutation(len(done))
    sampled = [done[p] for p in picks[: run.workload["check_kin_files"]]]
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    expected, wrong, distinct = _judge(run, kin_paths=[j.result["kin"] for j in sampled])
    cells_of = {j.index: w for j, w in zip(sampled, wrong)}
    fields_wrong_total, wrong_jobs = 0, 0
    for job in done:
        bad = fields_wrong(index._meta(job.result["kin"] + ".json"), expected)
        fields_wrong_total += len(bad)
        wrong_jobs += bool(bad or cells_of.get(job.index, 0))
    run.state["jobs_wrong"] = wrong_jobs
    run.work.update(bases=run.state["bases"], valid_windows=expected["num_kmers"],
                    kmer_len=run.config["kmer_len"], distinct_cells=distinct)
    run.state["info"].update(
        kin_files_compared=len(sampled), valid_windows=expected["num_kmers"],
        distinct_cells=distinct,
        reference_peak_bytes=torch.cuda.max_memory_allocated(run.device) if on_card else None)
    return {"kin_bytes_wrong": (max(wrong, default=0), LIMITS["kin_bytes_wrong"]),
            "meta_fields_wrong": (fields_wrong_total, LIMITS["meta_fields_wrong"])}
