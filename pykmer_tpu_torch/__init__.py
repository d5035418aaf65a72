"""pykmer_tpu_torch — the PyTorch / CUDA port of pykmer_tpu.

This package indexes FASTA into the same `.kin` + `.kin.json` files as
``pykmer_tpu`` (byte-identical `.kin`), on an NVIDIA GPU. The device work is
torch ops plus hand-written CUDA kernels (``csrc/``); the host layer reuses
pykmer_tpu's JAX-free modules (``formats``, ``io``, ``utils``, ``config``,
``oracle``). It never imports jax.

Layout
------
- ``config``  : chunk-size defaults per device
- ``host``    : numpy FASTA decode + chunk framing / 2-bit packing
- ``ops``     : device programs — encode, sort, the saturating sweep kernel
                and its plain version, readback
- ``state``   : folded-plane exchange with numpy (and the JAX package)
- ``index``   : the single-GPU indexer
- ``csrc``    : CUDA C++ kernel sources, built at first use

Every public function takes an explicit ``device``; nothing falls back to
the CPU when CUDA is missing.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"


def require_cuda() -> None:
    """Raise unless a CUDA device is usable."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available (torch.cuda.is_available() is False); "
            "pass device='cpu' explicitly to run the plain torch versions"
        )


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
