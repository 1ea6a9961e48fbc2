"""K2 (resample) and K3 (phase-vocoder resynthesis) of the port against the
JAX package's TPU kernels, run in interpret mode on the CPU.

On the CPU each wrapper runs its plain twin, so these tests hold the twins'
arithmetic to the TPU kernels'; ``chip_smoke.py`` holds the CUDA kernels to
the twins on the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from freesound_classification_tpu.ops import augment as ja
from freesound_classification_tpu.ops import pallas_kernels as jk
from freesound_classification_tpu.ops import pv as jpv
from freesound_classification_tpu_torch.ops import augment, kernels, pv

N_FFT, HOP = 1024, 256


def _wave(b, l, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(l) / 44100.0
    tones = np.sin(2 * np.pi * rng.uniform(100, 4000, (b, 1)) * t)
    return (0.3 * tones + 0.05 * rng.randn(b, l)).astype(np.float32)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factors", [(0.85, 1.31), (1.0, 1.8), (0.5, 1.1)])
def test_resample_twin_matches_tpu_kernel(factors):
    """Over the whole buffer, the zero reads past L included. The port
    rounds pos = i * factor to float32, as the kernel's definition says;
    XLA evaluates the interpret-mode kernel's ``i * f - tile_start`` as one
    fused multiply-add, whose position is finer by up to half a float32
    step of i * f. The tolerance is that half step times the largest
    difference of neighbouring samples, plus 1e-6 for the sum."""
    b, l = 2, 65536
    wave = _wave(b, l, 0)
    f = np.asarray(factors, np.float32)
    want = np.asarray(jk.resample_linear_pallas(jnp.asarray(wave),
                                                jnp.asarray(f)))
    got = kernels.resample_linear(torch.from_numpy(wave),
                                  torch.from_numpy(f)).numpy()
    assert got.shape == want.shape
    half_step = 0.5 * np.spacing(np.float32(l * f.max()))
    tol = half_step * np.abs(np.diff(wave, axis=1)).max() + 1e-6
    assert np.abs(got - want).max() <= tol


def test_resample_rejects_factors_outside_the_kernel_domain():
    wave = torch.zeros(2, 4096)
    with pytest.raises(ValueError, match="1.8"):
        kernels.resample_linear(wave, torch.tensor([1.0, 1.81]))


def test_resample_wrong_factor_fails_by_far():
    """A factor one percent off moves samples by far more than the
    tolerance: the comparison above can tell."""
    wave = torch.from_numpy(_wave(1, 65536, 1))
    a = kernels.resample_linear(wave, torch.tensor([1.1]))
    c = kernels.resample_linear(wave, torch.tensor([1.1 * 1.01]))
    assert float((a - c).abs().max()) > 1e3 * 1e-6


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("factors", [(0.87, 1.31), (1.0, 1.12)])
def test_masked_resample_matches_jax_resample_rate(use_pallas, factors):
    """The chain's call, K2 masked to the valid lengths in its store
    (``augment.resample_rate`` on the CPU: the masked plain twin), against
    the JAX ``resample_rate`` on the TPU kernel (interpret mode) and on its
    gather path, with lengths below L: the same float32 mask, the same new
    lengths, and the tolerance of ``test_resample_twin_matches_tpu_kernel``
    (the gather path clamps its taps at L - 1, which lengths below L never
    reach)."""
    b, l = 2, 65536
    wave = _wave(b, l, 6)
    f = np.asarray(factors, np.float32)
    lengths = np.asarray([l - 20000, l // 2 + 3], np.int32)
    want, want_len = ja.resample_rate(jnp.asarray(wave), jnp.asarray(lengths),
                                      jnp.asarray(f), use_pallas=use_pallas)
    got, got_len = augment.resample_rate(*(torch.from_numpy(x)
                                           for x in (wave, lengths, f)))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    half_step = 0.5 * np.spacing(np.float32(l * f.max()))
    tol = half_step * np.abs(np.diff(wave, axis=1)).max() + 1e-6
    assert np.abs(got.numpy() - np.asarray(want)).max() <= tol
    pos = np.arange(l, dtype=np.float32)[None] * f[:, None]
    masked = pos >= lengths[:, None]
    assert masked.sum(axis=1).min() > 1000
    assert not got.numpy()[masked].any()


def test_resample_mask_at_full_length_is_the_unmasked_twin():
    """lengths = L masks nothing the taps did not already zero: bit for
    bit the unmasked function, so the unmasked checks keep their meaning."""
    l = 20000
    wave = torch.from_numpy(_wave(3, l, 7))
    f = torch.tensor([0.9, 1.3, 1.8])
    full = torch.full((3,), l, dtype=torch.int32)
    a = kernels.resample_linear(wave, f).numpy()
    for got in (kernels.resample_linear(wave, f, full),
                kernels.resample_linear_reference(wave, f, full)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      a.view(np.uint32))
    assert (a[2, int(l / 1.8) + 2:] == 0).all()  # past L / 1.8: zero taps


def test_resample_lengths_a_tenth_short_fail_by_far():
    """The wrong input the card's check runs: lengths a tenth of a clip
    short move the masked output by far more than the tolerance."""
    l = 65536
    wave = torch.from_numpy(_wave(2, l, 8))
    f = torch.tensor([0.95, 1.2])
    lengths = torch.tensor([l - 3000, l // 2], dtype=torch.int32)
    want = kernels.resample_linear(wave, f, lengths)
    short = kernels.resample_linear(wave, f, lengths - l // 10)
    assert float((short - want).abs().max()) > 1e3 * 1e-6


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def _pv_inputs(b, t_in, seed, quantize):
    rng = np.random.RandomState(seed)
    f = N_FFT // 2 + 1
    mag = np.abs(rng.randn(b, t_in, f)).astype(np.float32)
    expected = 2 * np.pi * np.arange(f) / N_FFT * HOP
    dphi = rng.uniform(-np.pi, np.pi, (b, t_in - 1, f)) + expected
    if quantize:
        # multiples of 1/16 below 2^19: every partial sum is exact in
        # float32, so any summation order gives the same phase
        dphi = np.round(dphi * 16) / 16
    phase0 = rng.uniform(-np.pi, np.pi, (b, f))
    return mag, dphi.astype(np.float32), phase0.astype(np.float32)


def _k3_both(mag, dphi, phase0, rate, t_out):
    icos, isin = jpv._synthesis_basis(N_FFT)
    want = np.asarray(jk._pv_resynth(
        jnp.asarray(mag), jnp.asarray(dphi), jnp.asarray(phase0),
        jnp.asarray(rate), jnp.asarray(icos), jnp.asarray(isin), N_FFT,
        t_out, HOP, interpret=True))
    got = kernels.pv_resynth(
        *(torch.from_numpy(x) for x in (mag, dphi, phase0, rate)),
        torch.from_numpy(icos).bfloat16(), torch.from_numpy(isin).bfloat16(),
        HOP, t_out).numpy()
    return got, want


def test_synthesis_basis_is_the_jax_packages():
    for a, c in zip(kernels.synthesis_basis(N_FFT),
                    jpv._synthesis_basis(N_FFT)):
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("rate", [(1.0, 1.0), (0.84, 1.19), (1.3, 0.5)])
def test_pv_resynth_twin_matches_tpu_kernel(rate):
    """Exactly summable phase steps (large, as real ones: ~800 rad per hop
    at the top bin) leave only rounding flips of the bf16 synthesis frames:
    every output row of all three 128-frame tiles agrees to one bf16 step
    of the largest output (2^-7 relative), the tile carries and the frames
    past t_out included."""
    mag, dphi, phase0 = _pv_inputs(2, 260, 0, quantize=True)
    got, want = _k3_both(mag, dphi, phase0, np.asarray(rate, np.float32),
                         t_out=300)
    assert got.shape == want.shape == (2, 300 + N_FFT // HOP - 1, HOP)
    tol = 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    assert np.median(np.abs(got - want)) == 0.0


def test_pv_resynth_twin_with_real_phase_steps():
    """Unrounded phase steps: the JAX kernel's in-tile sums (a float32 dot)
    add in another order than the port's left-to-right running sum, and at
    ~1e5 rad one float32 step is ~8e-3 rad; outputs then agree to 5e-2 of
    the largest, and the typical sample to a bf16 step."""
    mag, dphi, phase0 = _pv_inputs(2, 260, 1, quantize=False)
    got, want = _k3_both(mag, dphi, phase0,
                         np.asarray([0.9, 1.15], np.float32), t_out=300)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 5e-2 * scale
    assert np.median(np.abs(got - want)) <= 2.0 ** -8 * scale


def test_pv_resynth_shifted_frames_fail_by_far():
    """Analysis frames shifted by one give errors far above the tolerance."""
    mag, dphi, phase0 = _pv_inputs(1, 140, 2, quantize=True)
    rate = np.asarray([1.0], np.float32)
    got, want = _k3_both(mag, dphi, phase0, rate, t_out=150)
    shifted, _ = _k3_both(np.roll(mag, 1, axis=1), np.roll(dphi, 1, axis=1),
                          phase0, rate, t_out=150)
    tol = 2.0 ** -7 * np.abs(want).max()
    assert np.abs(shifted - want).max() > 10 * tol


def test_pv_resynth_rejects_rates_outside_the_kernel_domain():
    mag, dphi, phase0 = _pv_inputs(1, 20, 3, quantize=True)
    icos, isin = (torch.from_numpy(x).bfloat16()
                  for x in kernels.synthesis_basis(N_FFT))
    with pytest.raises(ValueError, match="1.3"):
        kernels.pv_resynth(torch.from_numpy(mag), torch.from_numpy(dphi),
                           torch.from_numpy(phase0), torch.tensor([1.31]),
                           icos, isin, HOP, 20)


def test_pv_stretch_matches_the_jax_kernel_route():
    """The whole stretch (torch.stft analysis, K3, normalization, crop)
    against the JAX package's kernel route at 2 x 65536: the analyses differ
    in rounding (torch.stft against a block-DFT matmul) and phases then
    drift by float32 steps of ~1e5 rad sums, so the check is the
    normalized correlation and the relative error over the valid region."""
    b, l = 2, 65536
    wave = _wave(b, l, 4)
    lengths = np.asarray([l, l - 5000], np.int32)
    rate = np.asarray([0.9, 1.15], np.float32)
    want, want_len = jpv._pv_stretch_impl(
        jnp.asarray(wave), jnp.asarray(lengths), jnp.asarray(rate), N_FFT,
        HOP, use_kernel=True)
    got, got_len = pv.phase_vocoder_stretch(
        torch.from_numpy(wave), torch.from_numpy(lengths),
        torch.from_numpy(rate), N_FFT, HOP)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for i in range(b):
        n = int(want_len[i])
        corr = np.corrcoef(got[i, :n], want[i, :n])[0, 1]
        rel = (np.linalg.norm(got[i, :n] - want[i, :n])
               / np.linalg.norm(want[i, :n]))
        assert corr > 0.999 and rel < 5e-2, (i, corr, rel)
        assert not got[i, n:].any()


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises: the
    wrappers never take the plain twin for it. Here, with no card, a
    tensor on another device raises in the wrappers' device checks."""
    wave = torch.zeros(1, 4096, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.resample_linear(wave, torch.ones(1, device="meta"))
    mag, dphi, phase0 = (torch.from_numpy(x).to("meta")
                         for x in _pv_inputs(1, 20, 5, quantize=True))
    icos, isin = (torch.from_numpy(x).bfloat16()
                  for x in kernels.synthesis_basis(N_FFT))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pv_resynth(mag, dphi, phase0, torch.ones(1, device="meta"),
                           icos, isin, HOP, 20)
