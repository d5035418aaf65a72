"""The port's saturating sweep (plain version, CPU) vs the JAX package.

The port's ``ops.sweep.accumulate_sorted`` runs its plain torch version on a
CPU tensor. It is held, exactly (integer counting, tolerance 0), against the
Pallas tile sweep in interpret mode, the XLA scatter version, and an
independent numpy count — on planes prefilled through ``state``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pykmer_tpu.ops.histogram import saturating_accumulate_sorted as jax_scatter
from pykmer_tpu.ops.histogram import sort_codes_fast as jax_sort
from pykmer_tpu.ops.pallas_hist import (
    accumulate_sorted_pallas,
    accumulate_sorted_planes,
    localize_sorted,
)
from pykmer_tpu_torch.ops import sweep
from pykmer_tpu_torch.ops.histogram import saturating_accumulate_sorted, sort_codes_fast
from pykmer_tpu_torch.state import plane_from_numpy, plane_to_numpy

CELLS = 4**7  # 16384 = 128 rows x 128 lanes
IMAX = np.iinfo(np.int32).max


def _prefilled(rng, cells=CELLS):
    plane = rng.integers(0, 256, size=cells).astype(np.uint8)
    plane[rng.random(cells) < 0.5] = 0
    plane[:64] = rng.integers(250, 256, size=64)  # cells near saturation
    return plane


def _port(plane, codes):
    t = plane_from_numpy(plane.reshape(-1, 128), "cpu")
    out = sweep.accumulate_sorted(t, torch.from_numpy(codes))
    assert out is t  # updated in place
    return plane_to_numpy(t)


def _pallas(plane, codes, tile_rows, block):
    dense = jnp.asarray(plane.reshape(-1, 128))
    out = accumulate_sorted_pallas(dense, jnp.asarray(codes), tile_rows=tile_rows,
                                   block=block, interpret=True)
    return np.asarray(out).reshape(-1)


def _numpy(plane, codes):
    c = codes[(codes >= 0) & (codes < plane.shape[0])].astype(np.int64)
    n = np.minimum(np.bincount(c, minlength=plane.shape[0]), 255)
    return np.minimum(plane.astype(np.int64) + n, 255).astype(np.uint8)


def _batch(rng, kind):
    if kind == "random":
        codes = rng.integers(0, CELLS, size=2000)
        codes[:500] = rng.integers(0, 70, size=500)  # hot cells, incl. prefilled ones
        codes[500:520] = CELLS  # folded sentinel
        codes[520:530] = IMAX  # the Pallas pad value
    elif kind == "saturation":
        codes = np.concatenate([np.full(600, 3), np.full(300, 70), [CELLS - 1] * 256])
    elif kind == "all_sentinel":
        codes = np.full(64, CELLS)
    elif kind == "empty":
        codes = np.zeros(0)
    return np.sort(codes.astype(np.int32))


@pytest.mark.parametrize("tile_rows,block", [(8, 32), (16, 16)])
@pytest.mark.parametrize("kind", ["random", "saturation", "all_sentinel", "empty"])
def test_sweep_matches_pallas_and_scatter(kind, tile_rows, block):
    rng = np.random.default_rng(11)
    plane = _prefilled(rng)
    codes = _batch(rng, kind)
    got = _port(plane, codes)
    assert np.array_equal(got, _pallas(plane, codes, tile_rows, block))
    want, _ = jax_scatter(jnp.asarray(plane), jnp.asarray(codes), sentinel=CELLS)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, _numpy(plane, codes))


def test_sweep_localize_bands_match_pallas():
    """Codes localised to a sub-range (-1 below, int32 max above) as the JAX
    package's K>=17 sub-plane sweep feeds them: the bands are ignored."""
    rng = np.random.default_rng(12)
    lo, hi = 3 * CELLS, 4 * CELLS
    glob = np.sort(rng.integers(0, 6 * CELLS, size=3000).astype(np.int64))
    local = np.array(localize_sorted(jnp.asarray(glob), lo, hi))
    assert (local == -1).any() and (local == IMAX).any()
    plane = _prefilled(rng)
    got = _port(plane, local)
    assert np.array_equal(got, _pallas(plane, local, 8, 32))
    assert np.array_equal(got, _numpy(plane, local))


def test_sweep_int64_codes_match_subplane_sweep():
    """int64 codes, some beyond 2^31 (the K>=17 range), on one flat plane vs
    the JAX package's tuple-of-sub-planes sweep and its XLA scatter."""
    rng = np.random.default_rng(13)
    plane = _prefilled(rng)
    codes = rng.integers(0, CELLS, size=2500).astype(np.int64)
    codes[:400] = rng.integers(0, 8, size=400)
    codes[400:450] = CELLS
    codes[450:470] = 2**33 + 7
    codes = np.sort(codes)
    got = _port(plane, codes)
    halves = (jnp.asarray(plane[: CELLS // 2].reshape(-1, 128)),
              jnp.asarray(plane[CELLS // 2 :].reshape(-1, 128)))
    out = accumulate_sorted_planes(halves, jnp.asarray(codes), tile_rows=8,
                                   block=32, interpret=True)
    assert np.array_equal(got, np.concatenate([np.asarray(p).reshape(-1) for p in out]))
    want, _ = jax_scatter(jnp.asarray(plane), jnp.asarray(codes), sentinel=CELLS)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, _numpy(plane, codes))


def test_repeated_batches_saturate_like_one_total():
    """Batching cannot change the result: min(total, 255) per cell."""
    rng = np.random.default_rng(14)
    plane = torch.zeros(CELLS, dtype=torch.uint8)
    total = np.zeros(CELLS, dtype=np.int64)
    for _ in range(4):
        codes = rng.integers(0, CELLS, size=3000)
        codes[:800] = rng.integers(0, 5, size=800)
        total += np.bincount(codes, minlength=CELLS)
        sweep.accumulate_sorted(plane, sort_codes_fast(torch.from_numpy(codes)))
    assert np.array_equal(plane.numpy(), np.minimum(total, 255))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_sort_codes_fast_matches_jax(dtype):
    rng = np.random.default_rng(15)
    codes = rng.integers(0, 2**30, size=5000).astype(dtype)
    codes[:100] = 2**30  # sentinels sort last
    got = sort_codes_fast(torch.from_numpy(codes)).numpy()
    assert got.dtype == dtype
    assert np.array_equal(got, np.asarray(jax_sort(jnp.asarray(codes))))


def test_state_roundtrip_2d_and_flat():
    rng = np.random.default_rng(16)
    folded = rng.integers(0, 256, size=(64, 128)).astype(np.uint8)
    t2 = plane_from_numpy(folded, "cpu")
    t1 = plane_from_numpy(folded.reshape(-1), torch.device("cpu"))
    assert t2.shape == t1.shape == (64 * 128,) and t2.dtype == torch.uint8
    assert np.array_equal(plane_to_numpy(t2), folded.reshape(-1))
    assert np.array_equal(plane_to_numpy(t1), folded.reshape(-1))
    folded[0, 0] ^= 1  # the tensor holds a copy
    assert plane_to_numpy(t2)[0] != folded[0, 0]
    with pytest.raises(ValueError):
        plane_from_numpy(folded.astype(np.int16), "cpu")


def test_sweep_rejects_bad_inputs():
    plane = torch.zeros(256, dtype=torch.uint8)
    codes = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        sweep.accumulate_sorted(plane.to(torch.int16), codes)
    with pytest.raises(ValueError, match="uint8"):
        sweep.accumulate_sorted(plane.reshape(16, 16), codes)
    with pytest.raises(ValueError, match="int32/int64"):
        sweep.accumulate_sorted(plane, codes.float())
    with pytest.raises(ValueError, match="int32/int64"):
        sweep.accumulate_sorted(plane, torch.arange(20, dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match="sorted"):
        sweep.accumulate_sorted(plane, codes.flip(0).contiguous())
    with pytest.raises(ValueError, match="codes on meta"):
        sweep.accumulate_sorted(plane, codes.to("meta"))


def test_cpu_path_counts_no_launch():
    before = sweep.LAUNCHES
    plane = torch.zeros(256, dtype=torch.uint8)
    sweep.accumulate_sorted(plane, torch.tensor([1, 1, 2], dtype=torch.int64))
    assert plane[1] == 2 and plane[2] == 1
    assert sweep.LAUNCHES == before


def test_plain_version_matches_numpy_on_large_codes():
    """The plain version alone: int64 codes above 2^31 on a small plane are
    ignored, as are negative codes."""
    rng = np.random.default_rng(17)
    plane = _prefilled(rng)
    codes = np.sort(np.concatenate([
        rng.integers(0, CELLS, size=1000), [-5, -1, 2**31, 2**40],
    ]).astype(np.int64))
    t = plane_from_numpy(plane, "cpu")
    saturating_accumulate_sorted(t, torch.from_numpy(codes))
    assert np.array_equal(t.numpy(), _numpy(plane, codes))
