"""The port's ``pv.pitch_shift``, ``freeverb.freeverb_ir``,
``blocks.masked_mean_time`` and ``blocks.ConvLockedDropout`` against the
JAX package's functions, on the CPU.

On the CPU ``pitch_shift`` runs K3's and K2's plain twins
(``kernels.pv_resynth``, ``kernels.resample_linear``); ``chip_smoke.py``
holds the kernels to them on the card. The JAX package stretches small
inputs with its XLA phase carry and the port with the kernel's (ROADMAP
Pinned, "K3's phase"), so the whole shift is held against JAX's kernel
route, and the composition around the stretch against JAX's with one
stretch shared by both.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.models import blocks as jblocks
from freesound_classification_tpu.ops import freeverb as jfv
from freesound_classification_tpu.ops import pv as jpv
from freesound_classification_tpu_torch.models import blocks
from freesound_classification_tpu_torch.ops import freeverb, pv

PV_SR = 8192  # the JAX pitch tests' rate and sizes
N_FFT, HOP = 1024, 256


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes, many small ops: one intra-op thread, torch's and the
    BLAS/OpenMP pools', is fastest, and keeps the suite's parallel
    workers from oversubscribing the cores."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


def _tone(freq, n, sr=PV_SR):
    t = np.arange(n) / sr
    return np.sin(2 * np.pi * freq * t).astype("f4")


def _dominant_freq(x, sr=PV_SR):
    spec = np.abs(np.fft.rfft(x * np.hanning(x.size)))
    return np.fft.rfftfreq(x.size, 1 / sr)[np.argmax(spec)]


def _waves(b, l, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(l) / PV_SR
    tones = np.sin(2 * np.pi * rng.uniform(100, 2000, (b, 1)) * t)
    wave = (0.3 * tones + 0.05 * rng.randn(b, l)).astype(np.float32)
    lengths = np.asarray([l, l - 3000][:b], np.int32)
    wave[np.arange(l)[None] >= lengths[:, None]] = 0.0
    return wave, lengths


# ---------------------------------------------------------------------------
# pitch_shift
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cents,fratio", [(300, 2 ** 0.25),
                                          (-300, 2 ** -0.25)])
def test_pitch_shift_moves_the_pitch_and_keeps_the_duration(cents, fratio):
    """The JAX tests' own checks (``tests/test_pv.py``) on the port: a
    440 Hz tone's dominant frequency within 25 Hz of 440 f, the duration
    within 5 %."""
    out, new_len = pv.pitch_shift(torch.from_numpy(_tone(440, PV_SR)[None]),
                                  torch.tensor([PV_SR]),
                                  torch.tensor([float(cents)]), N_FFT, HOP)
    assert abs(int(new_len[0]) - PV_SR) < 0.05 * PV_SR
    got = _dominant_freq(out[0, 2000:6000].numpy())
    assert abs(got - 440 * fratio) < 25, (got, 440 * fratio)


def test_pitch_shift_by_zero_cents_is_near_identity():
    out, new_len = pv.pitch_shift(torch.from_numpy(_tone(440, PV_SR)[None]),
                                  torch.tensor([PV_SR]), torch.tensor([0.0]),
                                  N_FFT, HOP)
    assert int(new_len[0]) == PV_SR
    assert abs(_dominant_freq(out[0, 2000:6000].numpy()) - 440) < 10


@pytest.mark.parametrize("cents", [(-300.0, 170.0), (0.0, 300.0)])
def test_pitch_shift_composes_as_jax_around_one_stretch(monkeypatch, cents):
    """Both functions with the same stand-in stretch (a scale by 1/2 and
    JAX's new lengths, computed in numpy): the buffer's headroom, the
    factors, the resample (K2's twin against JAX's XLA resample), the crop
    and the lengths agree, the lengths exactly and the waves to 1e-5 of
    the largest."""
    wave, lengths = _waves(2, 6000, 0)
    cents = np.asarray(cents, np.float32)
    seen = {}

    def stand_in(xp, wave, lengths, rate, n_fft, hop):
        seen.setdefault("shapes", []).append(tuple(wave.shape))
        new_len = np.minimum((np.asarray(lengths, np.float32)
                              / np.asarray(rate)).astype(np.int32),
                             wave.shape[1])
        seen.setdefault("new_len", []).append(new_len)
        if xp is torch:
            return 0.5 * wave, torch.from_numpy(new_len)
        return 0.5 * wave, jnp.asarray(new_len)

    monkeypatch.setattr(jpv, "phase_vocoder_stretch",
                        functools.partial(stand_in, jnp))
    monkeypatch.setattr(pv, "phase_vocoder_stretch",
                        functools.partial(stand_in, torch))
    want, want_len = jpv.pitch_shift(jnp.asarray(wave), jnp.asarray(lengths),
                                     jnp.asarray(cents), N_FFT, HOP)
    got, got_len = pv.pitch_shift(torch.from_numpy(wave),
                                  torch.from_numpy(lengths),
                                  torch.from_numpy(cents), N_FFT, HOP)
    assert seen["shapes"][0] == seen["shapes"][1] == (2, 7424)
    np.testing.assert_array_equal(seen["new_len"][0], seen["new_len"][1])
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.dtype == torch.int32
    want = np.asarray(want)
    assert got.shape == want.shape == wave.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_pitch_shift_matches_the_jax_kernel_route(monkeypatch):
    """The whole shift against JAX's with its stretch on the kernel route
    (its TPU kernel in interpret mode), at 2 x 12000 samples: the
    analyses differ in rounding (``torch.stft`` against a block-DFT
    matmul), so, as for the stretch alone (``test_torch_kernels_aug``),
    the check is the normalized correlation (> 0.999) and the relative
    error (< 5e-2) over each row's valid region and over the whole row
    (the resample's last samples past the new length read the clip's
    end); the lengths agree exactly."""
    wave, lengths = _waves(2, 12000, 1)
    cents = np.asarray([-250.0, 190.0], np.float32)
    monkeypatch.setattr(jpv, "phase_vocoder_stretch", functools.partial(
        jpv._pv_stretch_impl, use_kernel=True))
    want, want_len = jpv.pitch_shift(jnp.asarray(wave), jnp.asarray(lengths),
                                     jnp.asarray(cents), N_FFT, HOP)
    got, got_len = pv.pitch_shift(torch.from_numpy(wave),
                                  torch.from_numpy(lengths),
                                  torch.from_numpy(cents), N_FFT, HOP)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for i in range(2):
        for n in (int(want_len[i]), wave.shape[1]):
            corr = np.corrcoef(got[i, :n], want[i, :n])[0, 1]
            rel = (np.linalg.norm(got[i, :n] - want[i, :n])
                   / np.linalg.norm(want[i, :n]))
            assert corr > 0.999 and rel < 5e-2, (i, n, corr, rel)


# ---------------------------------------------------------------------------
# freeverb_ir
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rev,room", [(0.0, 0.0), (25.0, 40.0),
                                      (49.0, 10.0), (49.0, 49.0)])
def test_freeverb_ir_matches_jax(rev, room):
    """6000 samples of the wet impulse response at 44.1 kHz (the JAX
    test's length and parameters), both from float32 frequency samples
    of the same closed form: within 1e-6 absolute, where the responses
    peak near 2e-2 (the JAX test holds its own to 2e-4 of a float64
    time-domain simulation)."""
    want = np.asarray(jfv.freeverb_ir(jnp.asarray([rev], jnp.float32),
                                      jnp.asarray([room], jnp.float32),
                                      44100, 6000))
    got = freeverb.freeverb_ir(torch.tensor([rev]), torch.tensor([room]),
                               44100, 6000).numpy()
    assert got.shape == want.shape == (1, 6000)
    assert np.abs(got - want).max() < 1e-6
    assert np.abs(want).max() > 1e-3


def test_freeverb_ir_batches_rows_and_options():
    """Two rows with the other knobs set: each row is its own response,
    as JAX's, within 1e-6."""
    kw = dict(hf_damping=20.0, pre_delay_ms=5.0, wet_gain_db=-3.0)
    rev, room = [5.0, 45.0], [30.0, 45.0]
    want = np.asarray(jfv.freeverb_ir(jnp.asarray(rev), jnp.asarray(room),
                                      22050, 3000, **kw))
    got = freeverb.freeverb_ir(torch.tensor(rev), torch.tensor(room), 22050,
                               3000, **kw).numpy()
    assert np.abs(got - want).max() < 1e-6


# ---------------------------------------------------------------------------
# masked_mean_time and ConvLockedDropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_masked_mean_time_matches_jax(dtype):
    """(B, T, C) in JAX, (B, C, T) in the port; a row with no valid frame
    (length 0) is 0 in both. Within 1e-6 relative (float32) and 1e-12
    (float64)."""
    rng = np.random.RandomState(3)
    h = rng.randn(4, 11, 5).astype(dtype)
    lengths = np.asarray([11, 4, 1, 0], np.int32)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jblocks.masked_mean_time(jnp.asarray(h),
                                                   jnp.asarray(lengths)))
    got = blocks.masked_mean_time(torch.from_numpy(h).transpose(1, 2),
                                  torch.from_numpy(lengths)).numpy()
    tol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert not got[3].any()


def test_conv_locked_dropout_with_jax_s_mask():
    """JAX's module in train mode draws its mask from a ``dropout`` key;
    the port's with that mask injected (read off JAX's output, which keeps
    or zeroes whole channels) gives JAX's output exactly; in eval mode
    both are the identity."""
    import flax.linen as fnn

    del fnn  # the JAX module is a flax one
    rng = np.random.RandomState(4)
    x = (rng.rand(3, 9, 6) + 0.5).astype(np.float32)  # no zero in x
    module = jblocks.ConvLockedDropout(dropout_rate=0.4)
    want = np.asarray(module.apply({}, jnp.asarray(x), train=True,
                                   rngs={"dropout": jax.random.PRNGKey(0)}))
    kept = want != 0
    assert (kept == kept[:, :1, :]).all()  # one mask entry a row and channel
    assert 0 < kept.mean() < 1
    keep = torch.from_numpy(kept[:, :1, :].astype(np.float32)).transpose(1, 2)
    port = blocks.ConvLockedDropout(0.4).train()
    got = port(torch.from_numpy(x).transpose(1, 2), keep=keep)
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want)
    port.eval()
    assert torch.equal(port(torch.from_numpy(x)), torch.from_numpy(x))
    np.testing.assert_array_equal(
        np.asarray(module.apply({}, jnp.asarray(x), train=False)), x)


def test_conv_locked_dropout_draws_one_mask_a_channel_at_the_keep_rate():
    """Drawn from its generator: each row's channel is kept or zeroed
    across all its frames, the kept values unscaled; the keep rate of 64
    x 256 entries within 0.02 (about 6 sigma) of 1 - rate; the same
    generator seed gives the same mask; rate 0 is the identity."""
    x = torch.rand(64, 256, 12) + 0.5
    gen = torch.Generator().manual_seed(11)
    drop = blocks.ConvLockedDropout(0.3, generator=gen).train()
    out = drop(x)
    kept = out != 0
    assert torch.equal(kept, kept[:, :, :1].expand_as(kept))
    assert torch.equal(out[kept], x[kept])
    assert abs(kept[:, :, 0].float().mean().item() - 0.7) < 0.02
    gen.manual_seed(11)
    assert torch.equal(drop(x), out)
    assert torch.equal(blocks.ConvLockedDropout(0.0).train()(x), x)
