"""Device programs of the index path.

- ``encode``    : canonical k-mer codes (torch ops)
- ``histogram`` : keys-only sort + the plain saturating accumulate
- ``sweep``     : the CUDA saturating-sweep kernel's wrapper
- ``readback``  : device→host fetch, unfold, write + hash
- ``_build``    : nvcc build + ctypes load of ``csrc/`` (CUDA only)
"""
