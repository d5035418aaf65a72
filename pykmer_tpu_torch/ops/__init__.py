"""Device programs of the index path.

- ``encode``    : canonical k-mer codes: the CUDA encode kernels' wrappers
                and their plain torch versions
- ``histogram`` : keys-only sort + the plain saturating accumulate
- ``sweep``     : the CUDA saturating-sweep kernel's wrapper
- ``readback``  : the chased device→host tail: copy, unfold, write + hash,
                  in every readback mode, and the arena-free pieces tail
- ``packing``   : the readback modes' device ops (fixed-width packs, escape
                  counts and gathers, the sparse token stream) and the mode
                  choice
- ``compare``   : the merge's per-block step, V·Vᵀ into an int64 accumulator
- ``_build``    : nvcc build + ctypes load of ``csrc/`` (CUDA only)
"""
