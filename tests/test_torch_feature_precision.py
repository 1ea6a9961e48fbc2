"""Which of the port's two featurizations is nearer the reference's float32
log-mel features, on the CPU.

The reference featurizes in float32 (torch.stft, the mel product, log).
The JAX package's ``_logmel_xla`` at HIGHEST precision is that function
(its block DFT in full float32). The port has two featurizations of the
bench's descriptor, mel_2048_1024_128:

- V1, the frontend of the CLIs and the bench: ``torch.stft`` in float32 and
  K1's plain version (the mel product and the log in float32);
- V3, the fast featurization (``ops/fast_featurize.py``): the single-pass
  bf16 cat-DFT products and K9's plain version, the counterpart of the JAX
  bf16 bench's single-pass bf16 DFT (``dsp.py:268-273``).

On eight 3 s clips whose peak levels span 50 dB (-60 to -10 dBFS; noise
with a random spectral tilt plus three tones, the smoke's test clips), V1
is within 6.3e-5 of the reference everywhere (median 0: its float32 sums
differ only in order); V3 misses by up to 0.28 on the quiet bands (median
1.7e-3, 99th percentile 0.064): the bf16 DFT errs by ~2^-8 of each
block's level, which the log magnifies where a band is quiet. V1 is the
nearer, by a factor of over 4000 in the largest error and over 10000 in
the mean. (XLA on the CPU computes the "default" bf16 precision in
float32 too, so the JAX bf16 path itself cannot be run here; V3 computes
what it computes on a TPU.)
"""

import jax.numpy as jnp
import numpy as np
import torch

from freesound_classification_tpu.ops import dsp as jdsp
from freesound_classification_tpu_torch.ops import dsp, kernels
from freesound_classification_tpu_torch.ops import fast_featurize as ff

SR = 44100
N_FFT, HOP, N_MEL = 2048, 1024, 128

torch.set_float32_matmul_precision("highest")


def _clip(n, rng, peak_db):
    """Noise with a random spectral tilt plus three tones, at a peak level
    of ``peak_db`` dBFS."""
    spectrum = np.fft.rfft(rng.randn(n))
    spectrum *= np.arange(1, spectrum.size + 1) ** -rng.uniform(0.0, 1.5)
    noise = np.fft.irfft(spectrum, n)
    t = np.arange(n) / SR
    tones = sum(rng.uniform(0.0, 2.0)
                * np.sin(2 * np.pi * rng.uniform(60.0, 12000.0) * t)
                for _ in range(3))
    audio = noise / noise.std() + tones
    return audio * (10.0 ** (peak_db / 20) / np.abs(audio).max())


def test_float32_featurization_is_nearer_the_reference_than_bf16():
    """V1 nearer than V3, by over three decades."""
    rng = np.random.RandomState(0)
    wave = np.stack([_clip(3 * SR, rng, db) for db in
                     np.linspace(-60.0, -10.0, 8)]).astype(np.float32)
    peaks_db = 20 * np.log10(np.abs(wave).max(axis=1))
    assert peaks_db.max() - peaks_db.min() > 49.9
    fb = dsp.mel_filterbank(SR, N_FFT, N_MEL, fmin=5.0)
    ref = np.asarray(jdsp._logmel_xla(jnp.asarray(wave), jnp.asarray(fb.T),
                                      N_FFT, HOP, precision="highest"))
    v1 = dsp.log_mel_spectrogram(
        torch.from_numpy(wave), torch.from_numpy(fb), N_FFT, HOP,
        mel_project=kernels.mel_project_log_reference).numpy()
    v3 = ff.fast_featurize(
        torch.from_numpy(wave), torch.from_numpy(np.ascontiguousarray(fb.T)),
        torch.from_numpy(ff.cat_basis(N_FFT, HOP)).to(torch.bfloat16)
    ).numpy()
    assert v1.shape == v3.shape == ref.shape == (8, N_MEL, 130)
    err1, err3 = np.abs(v1 - ref), np.abs(v3 - ref)
    # V1: float32 sums in another order
    assert err1.max() <= 1e-3 and np.median(err1) <= 1e-6
    # V3: the bf16 DFT's error, magnified by the log on quiet bands
    assert 0.1 <= err3.max() <= 1.0 and 1e-4 <= np.median(err3) <= 1e-2
    # V1 is the nearer, by over three decades in the largest error
    assert err1.max() * 1000 < err3.max()
    assert err1.mean() * 1000 < err3.mean()
