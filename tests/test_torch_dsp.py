"""Parity of the port's featurization with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side's Pallas mel kernel runs in interpret mode, as its own tests run it.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from freesound_classification_tpu.models.frontend import Frontend as JaxFrontend
from freesound_classification_tpu.ops import dsp as jdsp
from freesound_classification_tpu.ops import pallas_kernels
from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops import dsp, kernels

SR = 44100
DESCRIPTOR = "mel_512_256_32"


def _waves(n, length, seed):
    rng = np.random.RandomState(seed)
    return (0.1 * rng.randn(n, length)).astype(np.float32)


@pytest.mark.parametrize("descriptor", [DESCRIPTOR, "mel_2048_1024_128"])
def test_descriptor_and_filterbank_match_jax(descriptor):
    feat = dsp.parse_features(descriptor)
    assert tuple(feat) == tuple(jdsp.parse_features(descriptor))
    assert feat.n_features == jdsp.parse_features(descriptor).n_features
    # the same numpy arithmetic on both sides: bit-equal
    np.testing.assert_array_equal(
        dsp.mel_filterbank(SR, feat.n_fft, feat.n_mel),
        jdsp.make_mel_filterbanks(descriptor, sr=SR))
    for length in (22050, 44100, 45056, 441000):
        assert dsp.feature_frames(length, descriptor) == \
            jdsp.feature_frames(length, descriptor)


def test_k1_twin_matches_jax_pallas_kernel():
    """(a) K1's plain twin against the JAX K1 (interpret mode) on identical
    re/im spectra. Tolerance 1e-5 abs on log-mel: both are float32 sums of
    the same non-negative products, so they differ only by summation order."""
    rng = np.random.RandomState(0)
    b, t, f, m = 3, 37, 257, 32
    re = rng.randn(b, t, f).astype(np.float32)
    im = rng.randn(b, t, f).astype(np.float32)
    fb = dsp.mel_filterbank(SR, 512, m)
    want = np.asarray(pallas_kernels.mel_project_log_ri(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(fb.T)))  # (B, M, T)
    spec = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    got = kernels.mel_project_log_reference(spec.transpose(1, 2),
                                            torch.from_numpy(fb))
    assert got.shape == (b, m, t)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_k1_wrapper_routes_cpu_to_twin_and_counts_no_launch():
    rng = np.random.RandomState(1)
    spec = torch.complex(torch.from_numpy(rng.randn(2, 257, 9).astype(np.float32)),
                         torch.from_numpy(rng.randn(2, 257, 9).astype(np.float32)))
    fb = torch.from_numpy(dsp.mel_filterbank(SR, 512, 32))
    before = kernels.mel_project_log.launches
    got = kernels.mel_project_log(spec, fb)
    assert kernels.mel_project_log.launches == before
    torch.testing.assert_close(
        got, kernels.mel_project_log_reference(spec, fb), atol=0, rtol=0)


def test_k1_wrapper_raises_off_cpu_without_cuda():
    """A tensor that is not on the CPU never reaches the plain twin."""
    fb = torch.zeros(32, 257)
    meta = torch.empty(2, 257, 9, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.mel_project_log(meta, fb)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.mel_project_log(torch.zeros(2, 257, 9, dtype=torch.complex64),
                                fb.to("meta"))


@pytest.mark.parametrize("length", [22050, 44100, 45056])
def test_log_mel_matches_jax_high_precision(length):
    """(b) torch.stft featurization against the JAX block-DFT at
    precision="high". Tolerance 1e-4 abs on log-mel: the DFT algorithms
    differ (FFT against bf16x3 matmuls, ~1e-6 relative on the spectrum;
    measured up to 5e-6 on log-mel)."""
    x = _waves(3, length, seed=2)
    feat = dsp.parse_features(DESCRIPTOR)
    fb = dsp.mel_filterbank(SR, feat.n_fft, feat.n_mel)
    want = np.asarray(jdsp.log_mel_spectrogram(
        jnp.asarray(x), jnp.asarray(fb), feat.n_fft, feat.hop_size,
        precision="high"))
    got = dsp.log_mel_spectrogram(torch.from_numpy(x), torch.from_numpy(fb),
                                  feat.n_fft, feat.hop_size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        dsp.featurize(torch.from_numpy(x), DESCRIPTOR).numpy(), want,
        atol=1e-4, rtol=0)


def test_featurize_rejects_non_mel():
    """Descriptors other than mel/stft/raw, and model families other than
    "1d"/"2d", raise; stft and raw descriptors are featurized
    (tests/test_torch_hierarchical.py holds them against JAX)."""
    with pytest.raises(ValueError, match="descriptor"):
        dsp.featurize(torch.zeros(1, 4096), "cqt_1024_256")
    with pytest.raises(ValueError, match="family"):
        Frontend(DESCRIPTOR, "3d")
    assert dsp.featurize(torch.zeros(1, 4096), "stft_1024_256").shape == \
        (1, 513, 17)
    assert dsp.featurize(torch.zeros(1, 4096), "raw").shape == (1, 1, 4096)


def test_frontend_matches_jax():
    """Frontend layout (B, F, T, 1) and clipped frame counts; log-mel values
    at the featurization tolerance (1e-4, see above)."""
    x = _waves(4, 45056, seed=3)
    lengths = np.array([45056, 30000, 255, 1], np.int32)
    x[1, 30000:] = 0.0
    want_in, want_fl = JaxFrontend(DESCRIPTOR, "2d", sr=SR)(
        jnp.asarray(x), jnp.asarray(lengths))
    front = Frontend(DESCRIPTOR, "2d", sr=SR, device="cpu")
    got_in, got_fl = front(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got_in.shape == want_in.shape
    np.testing.assert_array_equal(got_fl.numpy(), np.asarray(want_fl))
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in),
                               atol=1e-4, rtol=0)
    assert front.frame_count(45056) == got_in.shape[2]
