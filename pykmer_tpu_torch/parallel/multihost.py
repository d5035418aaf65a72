"""Multi-host glue of the port: so far only the shard checkpoints.

Copy of the checkpoint section of ``pykmer_tpu/parallel/multihost.py``,
with the same on-disk format, so a checkpoint written by either package
resumes in the other: the ``[S, local]`` dense shards in a step-tagged
``dense.<step>.npy`` and ``state.json`` as the single commit point, with the
stream cursor, ``num_kmers`` and the exchange-bucket high-water mark
``max_bucket``. The rest of that module (joining a job across hosts, input
splitting, the cross-host combine) is not yet ported.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Tuple

import numpy as np


def checkpoint_dir(index_tmp_file: str) -> str:
    return index_tmp_file + ".ckpt"


def save_shard_checkpoint(
    index_tmp_file: str,
    dense_shards: np.ndarray,
    next_step: int,
    num_kmers: int,
    meta: Optional[dict] = None,
    max_bucket: int = 0,
) -> None:
    """Atomically persist sharded progress.

    The dense plane lands in a STEP-TAGGED file (``dense.<step>.npy``) and
    the committed ``state.json`` names it: the state rename is the single
    commit point, so a crash anywhere in this function leaves the previous
    (state, dense) pair fully consistent. Superseded dense files are pruned
    after the commit.

    ``max_bucket`` — the running exchange-bucket high-water mark — rides
    along so the post-run overflow check still sees pre-checkpoint overflow
    after a resume (dropped k-mers would otherwise pass verification
    silently).
    """
    d = checkpoint_dir(index_tmp_file)
    os.makedirs(d, exist_ok=True)
    data_name = f"dense.{next_step}.npy"
    data_path = os.path.join(d, data_name)
    with open(data_path + ".tmp", "wb") as fh:
        np.save(fh, dense_shards, allow_pickle=False)
    os.rename(data_path + ".tmp", data_path)
    state = {"next_step": next_step, "num_kmers": num_kmers,
             "dense_file": data_name, "max_bucket": int(max_bucket)}
    state.update(meta or {})
    state_path = os.path.join(d, "state.json")
    with open(state_path + ".tmp", "wt") as fh:
        json.dump(state, fh, indent=1, sort_keys=True)
    os.rename(state_path + ".tmp", state_path)
    for name in os.listdir(d):
        if name.startswith("dense.") and name.endswith(".npy") \
                and name != data_name:
            try:
                os.remove(os.path.join(d, name))
            except OSError:
                pass


def load_shard_checkpoint(
    index_tmp_file: str,
) -> Optional[Tuple[np.ndarray, dict]]:
    d = checkpoint_dir(index_tmp_file)
    state_path = os.path.join(d, "state.json")
    if not os.path.exists(state_path):
        return None
    with open(state_path) as fh:
        state = json.load(fh)
    # legacy (pre-step-tag) checkpoints named the plane dense.npy
    data_path = os.path.join(d, state.get("dense_file", "dense.npy"))
    if not os.path.exists(data_path):
        return None
    dense = np.load(data_path)
    return dense, state


def clear_shard_checkpoint(index_tmp_file: str) -> None:
    d = checkpoint_dir(index_tmp_file)
    if os.path.exists(d):
        shutil.rmtree(d)
