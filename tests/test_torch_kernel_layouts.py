"""What the wrappers of K1, K3 and K9 hand their CUDA kernels, on the CPU.

K1 (``csrc/mel_log.cu``) sums each mel band over its range of bins only,
from ``kernels.mel_band_ranges``; K9 (``csrc/mel_log_split.cu``) does the
same from ``kernels.mel_band_pack`` (the ranges and each band's weights
side by side), a block for each ``kernels.split_plan`` tile of frames; K3
(``csrc/pv_resynth.cu``) streams the padded synthesis basis in wgmma's
shared-memory layout, from ``kernels.pv_basis_tiles``. The kernels
themselves run only on the card (``chip_smoke.py``); these tests hold their
inputs to numpy, to the plain twins and to ``kernels.synthesis_basis``.
"""

import numpy as np
import pytest
import torch

from freesound_classification_tpu_torch.ops import dsp, kernels

SR = 44100


def _filterbank(case):
    """(M, F) float32 filterbanks: the main path's mel filterbank, a dense
    one, one with an all-zero band, and one whose bands touch bin 0 and bin
    F - 1."""
    rng = np.random.RandomState(7)
    if case == "mel_2048_1024_128":
        return dsp.mel_filterbank(SR, 2048, 128)
    if case == "dense":
        return rng.uniform(0.01, 1.0, (16, 257)).astype(np.float32)
    fb = dsp.mel_filterbank(SR, 512, 32)
    if case == "zero_band":
        fb[5] = 0.0
        return fb
    assert case == "edges"
    fb[0, :3] = [0.5, 0.0, 0.25]  # non-zero at bin 0, a zero inside
    fb[-1, -2:] = [0.75, 1.0]     # non-zero at bin F - 1
    return fb


def _range_sum(spec, fb, lo, hi):
    """The kernel's function in float64: each band summed over [lo, hi)."""
    mag = np.abs(spec).astype(np.float64)  # (B, F, T)
    out = np.empty((spec.shape[0], fb.shape[0], spec.shape[2]))
    for m in range(fb.shape[0]):
        w = fb[m, lo[m]: hi[m]].astype(np.float64)
        out[:, m] = np.einsum("f,bft->bt", w, mag[:, lo[m]: hi[m]])
    return np.log(out + kernels.LOG_EPS)


@pytest.mark.parametrize("case", ["mel_2048_1024_128", "dense", "zero_band",
                                  "edges"])
def test_mel_band_ranges_match_numpy(case):
    """lo and hi are each band's first non-zero bin and one past its last
    (an empty range, lo >= hi, for a band with none), int32; summing over
    them alone gives the plain twin's log-mel (float32 summation order
    apart), and an all-zero band gives log(1e-4)."""
    fb = _filterbank(case)
    lo, hi = kernels.mel_band_ranges(torch.from_numpy(fb))
    assert lo.dtype == hi.dtype == torch.int32
    assert lo.shape == hi.shape == (fb.shape[0],)
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        if nz.size:
            assert (lo[m].item(), hi[m].item()) == (nz[0], nz[-1] + 1)
        else:
            assert lo[m].item() >= hi[m].item()
    if case == "edges":
        assert lo[0].item() == 0 and hi[-1].item() == fb.shape[1]
    rng = np.random.RandomState(3)
    b, t = 2, 9
    spec = (rng.randn(b, fb.shape[1], t)
            + 1j * rng.randn(b, fb.shape[1], t)).astype(np.complex64)
    want = kernels.mel_project_log_reference(
        torch.from_numpy(spec), torch.from_numpy(fb)).numpy()
    got = _range_sum(spec, fb, lo.numpy(), hi.numpy())
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if case == "zero_band":
        np.testing.assert_allclose(got[:, 5], np.log(kernels.LOG_EPS),
                                   rtol=1e-7)
        np.testing.assert_allclose(want[:, 5], np.log(kernels.LOG_EPS),
                                   rtol=1e-6)


def test_mel_filterbank_is_sparse_at_the_main_paths_shape():
    """At mel_2048_1024_128 the ranges the kernel sums over hold 2,014
    entries of the filterbank's 131,200 (bands 2-64 bins wide): the dense
    loop the redesign dropped multiplied 65 times as many."""
    fb = dsp.mel_filterbank(SR, 2048, 128)
    lo, hi = kernels.mel_band_ranges(torch.from_numpy(fb))
    widths = (hi - lo).numpy()
    assert int((fb != 0).sum()) == 2014
    assert widths.sum() == 2014 and widths.min() == 2 and widths.max() == 64


@pytest.mark.parametrize("case", ["mel_2048_1024_128", "dense", "zero_band",
                                  "edges"])
def test_mel_band_pack_rebuilds_the_filterbank(case):
    """K9's packed bands put every entry of a bf16 (F, M) filterbank back
    exactly (zeros past each band's range, an empty band all zero), with
    K1's ranges; summing each band's packed weights against the bf16
    magnitudes over its range gives the plain twin's log-mel, float32
    summation order apart."""
    fb_t = torch.from_numpy(np.ascontiguousarray(_filterbank(case).T)
                            ).bfloat16()
    n_freq, n_mel = fb_t.shape
    lo, hi, packed = kernels.mel_band_pack(fb_t)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert packed.shape == (n_mel, n_freq)
    k1_lo, k1_hi = kernels.mel_band_ranges(fb_t.T)
    assert torch.equal(lo, k1_lo) and torch.equal(hi, k1_hi)
    rebuilt = np.zeros((n_freq, n_mel), np.float32)
    widths = (hi - lo).numpy()
    for m in range(n_mel):
        n = max(int(widths[m]), 0)
        rebuilt[lo[m]: lo[m] + n, m] = packed[m, :n].numpy()
        assert not packed[m, n:].any()
    np.testing.assert_array_equal(rebuilt, fb_t.float().numpy())
    if case == "zero_band":
        assert widths[5] <= 0
    rng = np.random.RandomState(4)
    spec = torch.from_numpy(rng.randn(2, 9, 2 * n_freq).astype(np.float32)
                            ).bfloat16()
    mag = kernels.split_magnitude(spec, n_freq, n_freq).double()
    sums = torch.stack([
        mag[..., lo[m]: lo[m] + max(int(widths[m]), 0)]
        @ packed[m, :max(int(widths[m]), 0)].double()
        for m in range(n_mel)], dim=1)
    want = kernels.mel_log_split_reference(spec, fb_t, n_freq, n_freq)
    np.testing.assert_allclose(torch.log(sums + kernels.LOG_EPS).numpy(),
                               want.numpy(), atol=1e-5, rtol=0)


def test_mel_band_pack_is_cached_for_the_same_filterbank():
    """Packed once for the same unmodified filterbank (``FastFrontend``
    passes its own on every call), packed anew when it changes."""
    fb_t = torch.from_numpy(np.ascontiguousarray(
        _filterbank("zero_band").T)).bfloat16()
    first = kernels._band_pack_of(fb_t, fb_t._version)
    assert kernels._band_pack_of(fb_t, fb_t._version) is first
    fb_t[:, 5] = 1.0
    again = kernels._band_pack_of(fb_t, fb_t._version)
    assert again is not first
    assert (again[1] - again[0])[5].item() == fb_t.shape[0]


@pytest.mark.parametrize("n_rows,width", [(64 * 431, 2050), (64 * 431, 2052),
                                          (64 * 431, 2051), (256, 2304),
                                          (5, 40), (5, 41)])
def test_split_plan_covers_every_row_with_one_run_a_block(n_rows, width):
    """A block takes 4 rows (its last block fewer), one contiguous run of 4
    x W bf16 values; its shared memory holds the 16-byte chunks that
    enclose the run at any of the 8 offsets a bf16 run can start at (odd
    widths need the most: 8 W is 8 past a chunk)."""
    plan = kernels.split_plan(n_rows, width)
    assert kernels._K9_FRAMES == 4
    assert (plan.blocks - 1) * 4 < n_rows <= plan.blocks * 4
    for head in range(0, 16, 2):
        chunks = -(-(head + 4 * width * 2) // 16)
        assert chunks * 16 <= plan.smem
    assert plan.smem % 16 == 0 and plan.smem <= kernels._MAX_SHARED_BYTES
    if (n_rows, width) == (64 * 431, 2050):  # the probe's shape
        assert plan == (6896, 16416)


def test_split_plan_refuses_rows_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        kernels.split_plan(16, 29100)


def test_bf16_square_roots_lie_far_from_bf16_rounding_midpoints():
    """K9 rounds an approximate square root (sqrt.approx.f32) of each bf16
    |S|^2 to bf16. That is the correctly rounded root, as the plain twin
    computes it, because the exact root of every positive bf16 value lies
    at least 2^-19 of itself away from the nearest bf16 rounding midpoint,
    far more than the approximation's error (a few float32 steps, 2^-22
    each)."""
    bits = np.arange(1, 0x7F80, dtype=np.uint32) << 16  # every finite x > 0
    x = bits.view(np.float32).astype(np.float64)
    root = np.sqrt(x)
    # bf16 steps at the root (8 significant bits), and the midpoints around
    ulp = 2.0 ** (np.floor(np.log2(root)) - 7)
    mid = (np.floor(root / ulp) + 0.5) * ulp
    gap = np.min(np.abs(root[:, None] - (mid[:, None] + ulp[:, None]
                                         * np.array([-1.0, 0.0, 1.0]))),
                 axis=1)
    assert (gap / root).min() >= 2.0 ** -19.5
    # and rounding a root that errs by 2^-20 of itself, either way, to bf16
    # gives the correctly rounded root
    exact = torch.from_numpy(root).to(torch.bfloat16)
    for err in (-(2.0 ** -20), 2.0 ** -20):
        off = torch.from_numpy(root * (1 + err)).float().to(torch.bfloat16)
        assert torch.equal(off, exact)


def _basis_through_descriptors(tiles, o, q, wg, j):
    """The 128 x 16 B operand one wgmma of ``pv_resynth_kernel`` reads from
    stage (o, q): warpgroup ``wg``'s columns and the stage's k16 step
    ``j``, addressed as its descriptors do (no swizzle: 16-byte rows of 8
    x 8 core matrices, LBO 4096 bytes along k, SBO 128 along the
    columns), from the flat bytes of the stage."""
    stage = tiles[o, q].reshape(-1).float().numpy()  # 8192 bf16 values
    n = np.arange(128)[:, None]
    kk = np.arange(16)[None, :]
    start = wg * 16 * 128 + j * 2 * 4096
    byte = start + (kk // 8) * 4096 + (n // 8) * 128 + (n % 8) * 16 \
        + (kk % 8) * 2
    return stage[byte // 2]


@pytest.mark.parametrize("n_fft", [1024, 502])
def test_pv_basis_tiles_match_synthesis_basis(n_fft):
    """Every stage, read through the kernel's descriptor addressing, holds
    rows 32 q + 16 j + [0, 16) and columns o hop + 128 wg + [0, 128) of
    [icos; 0; isin; 0] in bf16, zero past hop (n_fft 502: hop 125, F 252
    padded to 256)."""
    hop = n_fft // 4
    icos, isin = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in kernels.synthesis_basis(n_fft))
    f = icos.shape[0]
    bins_pad = -(-f // 16) * 16
    full = np.zeros((2 * bins_pad, n_fft), np.float32)
    full[:f] = icos.float().numpy()
    full[bins_pad: bins_pad + f] = isin.float().numpy()
    tiles = kernels.pv_basis_tiles(icos, isin, hop)
    stages = 2 * bins_pad // 32
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
    assert tiles.shape == (4, stages, 4, 32, 8, 8)
    for o in range(4):
        for q in range(stages):
            for wg in range(2):
                for j in range(2):
                    got = _basis_through_descriptors(tiles, o, q, wg, j)
                    cols = o * hop + wg * 128 + np.arange(128)
                    rows = q * 32 + j * 16 + np.arange(16)
                    inside = cols < o * hop + hop
                    picked = full[rows[None, :],
                                  np.minimum(cols, n_fft - 1)[:, None]]
                    want = np.where(inside[:, None], picked, 0.0)
                    np.testing.assert_array_equal(got, want)


def test_pv_basis_tiles_are_cached_for_the_same_bases():
    """Built once for the same unmodified bases (``ops/pv.py`` passes its
    cached ones on every call), built anew when they change."""
    icos, isin = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in kernels.synthesis_basis(256))
    cpu = torch.device("cpu")
    first = kernels._cached_pv_basis_tiles(icos, isin, 64, cpu)
    assert kernels._cached_pv_basis_tiles(icos, isin, 64, cpu) is first
    isin.mul_(2.0)
    again = kernels._cached_pv_basis_tiles(icos, isin, 64, cpu)
    assert again is not first
    np.testing.assert_array_equal(
        again.float().numpy(),
        kernels.pv_basis_tiles(icos, isin, 64).float().numpy())
