"""pykmer_tpu_torch — the PyTorch / CUDA port of pykmer_tpu.

This package indexes FASTA into the same `.kin` + `.kin.json` files as
``pykmer_tpu`` (byte-identical `.kin`), and merges indexes into the same
`.kma` + `.kma.json`, on an NVIDIA GPU. The device work is torch ops plus
hand-written CUDA kernels (``csrc/``). It imports neither jax nor anything
of ``pykmer_tpu``: the JAX-free modules it needs (``formats``, ``io`` with
the C++ ``native`` library, ``utils``, ``config``, ``oracle``, ``analysis``,
``testgen``) are its own copies, each held against its original by
``tests/test_torch_copies.py``.

Layout
------
- ``config``  : the typed configuration, chunk-size defaults and the
                accumulate strategy per device
- ``formats``, ``io``, ``utils``, ``analysis``, ``oracle``, ``testgen``:
                copies of the JAX package's JAX-free modules — the `.kin` /
                `.kma` files, FASTA / bgzf / direct I/O with the C++
                ``native`` library (built under ``build/native/``), timers,
                checksums and profiling hooks, distances and trees, the
                numpy oracle, the fixture generator
- ``host``    : numpy FASTA decode, record-aligned segments, the streaming
                reader, the pipelined chunk producer, chunk framing / 2-bit
                packing
- ``ops``     : device programs — encode, sort, the saturating sweep kernel
                and its plain version, the chased readback tail, the merge's
                per-block V·Vᵀ step
- ``state``   : folded-plane and ``[S, local]`` shard exchange with numpy
                (and the JAX package)
- ``parallel``: multi-device runs in one process — the device mesh, the
                collectives as explicit copies, the count-space-sharded step,
                the sharded merge step, shard checkpoints
- ``index``   : the single-GPU indexer, the sharded indexer (checkpoints and
                resume), batch indexing, index verification
- ``merge``   : the N×N merge (host popcount and device engines, the device
                engine optionally sharded) → `.kma`
- ``serve``   : the JSON-lines service over index, merge and distance
- ``cli``     : ``python -m pykmer_tpu_torch <subcommand>``
- ``csrc``    : CUDA C++ kernel sources, built at first use

State the two packages share is on disk: the `.kin` and `.kma` files, both
read and written through the same ``formats`` code, and the sharded index's
checkpoints (the same ``[S, local]`` array and ``state.json``). The merge's
only device state, its int64 accumulator, comes back as a numpy array as the
JAX engine's does, so no conversion function is needed beyond ``state``'s.

Every public function takes an explicit ``device`` or ``mesh``; nothing
falls back to the CPU when CUDA is missing.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"


def require_cuda() -> None:
    """Raise unless a CUDA device is usable; initialise CUDA otherwise."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available (torch.cuda.is_available() is False); "
            "pass device='cpu' explicitly to run the plain torch versions"
        )
    # the allocator's per-card calls (reset_peak_memory_stats('cuda:n')) do
    # not initialise CUDA themselves and reject every card before it is
    torch.cuda.init()


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device: 'cuda[:n]' (checked usable) or 'cpu'."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


from .index import create_fasta_index  # noqa: E402

__all__ = ["create_fasta_index", "require_cuda", "resolve_device", "__version__"]
