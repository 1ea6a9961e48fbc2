"""What the wrappers of K1 and K3 hand their CUDA kernels, on the CPU.

K1 (``csrc/mel_log.cu``) sums each mel band over its range of bins only,
from ``kernels.mel_band_ranges``; K3 (``csrc/pv_resynth.cu``) streams the
padded synthesis basis in wgmma's shared-memory layout, from
``kernels.pv_basis_tiles``. The kernels themselves run only on the card
(``chip_smoke.py``); these tests hold their inputs to numpy and to
``kernels.synthesis_basis``.
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
