"""The port's augmentation ops against the JAX package's, on the CPU.

The JAX ops draw from ``jax.random`` keys inside; each test repeats those
draws from the same key splits and injects them into the port's ``apply_*``,
so both sides see the same numbers. The port's own ``draw_*`` functions are
held to their distributions instead.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.ops import augment as ja
from freesound_classification_tpu.ops import dsp as jdsp
from freesound_classification_tpu.ops import freeverb as jfv
from freesound_classification_tpu.ops import pv as jpv
from freesound_classification_tpu_torch.ops import augment as ta
from freesound_classification_tpu_torch.ops import dsp as tdsp
from freesound_classification_tpu_torch.ops import freeverb as tfv

SR = 44100


def _batch(b, l, seed, n_classes=5):
    rng = np.random.RandomState(seed)
    wave = (0.3 * rng.randn(b, l)).astype(np.float32)
    lengths = rng.randint(l // 4, l + 1, size=b).astype(np.int32)
    lengths[0] = l
    wave[np.arange(l)[None, :] >= lengths[:, None]] = 0.0
    labels = (rng.rand(b, n_classes) < 0.3).astype(np.float32)
    return wave, lengths, labels


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def test_shuffle_chunks_with_injected_draws():
    b, l = 4, 3 * SR + 1000  # 6 full chunks and a partial tail
    wave, lengths, _ = _batch(b, l, 0)
    lengths[1] = SR // 3  # fewer than two chunks: left alone
    key = jax.random.PRNGKey(3)
    want = ja.shuffle_chunks(jnp.asarray(wave), jnp.asarray(lengths), key,
                             0.7)
    k_apply, k_perm = jax.random.split(key)
    draws = ta.ShuffleDraws(
        *_t(jax.random.bernoulli(k_apply, 0.7, (b,)),
            jax.random.uniform(k_perm, (b, l // (SR // 2)))))
    got = ta.apply_shuffle_chunks(*_t(wave, lengths), draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), wave)


def test_flip_with_injected_draws():
    wave, lengths, _ = _batch(5, 4000, 1)
    key = jax.random.PRNGKey(4)
    want = ja.flip(jnp.asarray(wave), jnp.asarray(lengths), key, 0.6)
    apply = torch.from_numpy(np.asarray(jax.random.bernoulli(key, 0.6, (5,))))
    got = ta.apply_flip(*_t(wave, lengths), apply)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cutout_with_injected_draws():
    wave, lengths, _ = _batch(6, 5000, 2)
    key = jax.random.PRNGKey(5)
    want = ja.cutout(jnp.asarray(wave), jnp.asarray(lengths), key, 0.8)
    k_apply, k_start = jax.random.split(key)
    draws = ta.CutoutDraws(*_t(jax.random.bernoulli(k_apply, 0.8, (6,)),
                               jax.random.uniform(k_start, (6,))))
    got = ta.apply_cutout(*_t(wave, lengths), draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("with_pool", [True, False])
def test_mixup_or_with_injected_draws(quirk, with_pool):
    """Replace quirk and additive mix; partners from a clean pool of other
    clips or from the batch itself (equal-length pairs average)."""
    wave, lengths, labels = _batch(6, 3000, 6)
    pool = _batch(4, 3000, 7) if with_pool else None
    key = jax.random.PRNGKey(6)
    want = ja.mixup_or(
        jnp.asarray(wave), jnp.asarray(lengths), jnp.asarray(labels), key,
        0.7, quirk_replace=quirk,
        partner=None if pool is None else tuple(map(jnp.asarray, pool)))
    k_perm, k_apply, k_a, k_start = jax.random.split(key, 4)
    n_pool = 6 if pool is None else 4
    draws = ta.MixupDraws(*_t(
        np.asarray(jax.random.randint(k_perm, (6,), 0, n_pool)).astype(
            np.int64),
        jax.random.bernoulli(k_apply, 0.7, (6,)),
        jax.random.uniform(k_a, (6,), minval=0.4, maxval=0.6),
        jax.random.uniform(k_start, (6,))))
    got = ta.apply_mixup_or(*_t(wave, lengths, labels), draws,
                            partner=None if pool is None else _t(*pool),
                            quirk_replace=quirk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-7)


def test_iir_first_order_matches_jax_and_the_recurrence():
    """Full float32 blocks: within 2e-6 of the JAX function and of a float64
    recurrence over 3 x 2000 samples (a decay of 0.995 sums ~200 terms)."""
    rng = np.random.RandomState(8)
    u = rng.randn(3, 2000).astype(np.float32)
    got = tdsp.iir_first_order(torch.from_numpy(u), 0.995).numpy()
    want = np.asarray(jdsp.iir_first_order(jnp.asarray(u), 0.995))
    y = np.zeros_like(u, dtype=np.float64)
    for n in range(u.shape[1]):
        y[:, n] = u[:, n] + (0.995 * y[:, n - 1] if n else 0.0)
    scale = np.abs(y).max()
    assert np.abs(got - want).max() <= 2e-6 * scale
    assert np.abs(got - y).max() <= 2e-6 * scale


def test_overdrive_matches_jax():
    wave, _, _ = _batch(3, 3000, 9)
    gain = np.asarray([2.0, 6.5, 10.0], np.float32)
    want = np.asarray(ja.overdrive(jnp.asarray(wave), jnp.asarray(gain)))
    got = ta.overdrive(*_t(wave, gain)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_reverb_matches_jax():
    """Closed-form comb/allpass response on the FFT grid, dry + wet: both
    in complex64, within 1e-4 of the clip's peak; lengths exact."""
    wave, lengths, _ = _batch(2, 20000, 10)
    rev = np.asarray([0.0, 49.0], np.float32)
    room = np.asarray([12.5, 49.9], np.float32)
    want, want_len = jfv.reverb_batch(
        jnp.asarray(wave), jnp.asarray(lengths), jnp.asarray(rev),
        jnp.asarray(room), SR, use_mxu_fft=False)
    got, got_len = tfv.reverb_batch(*_t(wave, lengths, rev, room), SR)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= (
        1e-4 * np.abs(wave).max())


def _jax_chain(wave, lengths, rev, room, cents, gain, speed):
    """The JAX pieces in the chain's order, on their kernel routes."""
    from freesound_classification_tpu.ops import pallas_kernels as jk

    l = wave.shape[1]
    out, n = jfv.reverb_batch(wave, lengths, rev, room, SR,
                              use_mxu_fft=False)
    f = jnp.exp2(cents / 1200.0)
    n_fft = min(1024, max(256, l // 8))
    out, n = jpv._pv_stretch_impl(out, n, 1.0 / f, n_fft, n_fft // 4,
                                  use_kernel=True)
    out = ja.overdrive(out, gain)
    assert float(jnp.max(speed * f)) <= jk._RS_MAX_FACTOR
    return ja.resample_rate(out, n, speed * f, use_pallas=True)


def test_effects_chain_with_injected_parameters():
    """Three of four rows take the chain (fixed count round(0.75 * 4));
    the rows it skips pass through bit for bit. The chain's rows agree
    with the JAX pieces composed in its order in correlation and relative
    error: the PV's analysis and phase sums round differently (see
    test_torch_kernels_aug)."""
    b, l = 4, 65536
    wave, lengths, _ = _batch(b, l, 11)
    params = dict(rev=np.asarray([10, 45, 0, 30], np.float32),
                  room=np.asarray([5, 49, 20, 0], np.float32),
                  cents=np.asarray([-300, 120, 299, -40], np.float32),
                  gain=np.asarray([2, 9.9, 5, 3], np.float32),
                  speed=np.asarray([0.9, 1.1, 1.0, 0.95], np.float32))
    rows = np.asarray([0, 1, 3])
    draws = ta.EffectsDraws(torch.from_numpy(rows),
                            *_t(*params.values()))
    got, got_len = ta.apply_effects(*_t(wave, lengths), draws)
    got, got_len = got.numpy(), got_len.numpy()
    np.testing.assert_array_equal(got[2], wave[2])
    assert got_len[2] == lengths[2]
    want, want_len = _jax_chain(
        jnp.asarray(wave[rows]), jnp.asarray(lengths[rows]),
        *(jnp.asarray(v[rows]) for v in params.values()))
    want = np.asarray(want)
    np.testing.assert_array_equal(got_len[rows], np.asarray(want_len))
    for i, r in enumerate(rows):
        n = int(want_len[i])
        corr = np.corrcoef(got[r, :n], want[i, :n])[0, 1]
        rel = (np.linalg.norm(got[r, :n] - want[i, :n])
               / np.linalg.norm(want[i, :n]))
        assert corr > 0.999 and rel < 5e-2, (r, corr, rel)


@pytest.mark.parametrize("b,p,k", [(64, 0.75, 48), (20, 0.75, 15),
                                   (5, 0.5, 2), (1, 1.0, 1), (8, 0.0, 0)])
def test_effects_draws_count_and_ranges(b, p, k):
    gen = torch.Generator().manual_seed(b)
    d = ta.draw_effects(gen, b, p)
    assert d.rows.numel() == k and len(set(d.rows.tolist())) == k
    for v, lo, hi in ((d.reverberance, 0, 50), (d.room, 0, 50),
                      (d.cents, -300, 300), (d.gain, 2, 10),
                      (d.speed, 0.9, 1.1)):
        assert v.shape == (b,) and float(v.min()) >= lo
        assert float(v.max()) < hi
    # the chain's extremes stay inside the kernels' domains
    f = 2.0 ** (300 / 1200)
    assert 1.1 * f <= 1.8 and f <= 1.3


def test_draws_follow_their_distributions():
    """Over 20000 rows: bernoulli rates within 2%, U(0.4, 0.6) weights and
    uniform partners, and every row equally likely to take the chain."""
    gen = torch.Generator().manual_seed(0)
    d = ta.draw_mixup(gen, 20000, 7, 0.5)
    assert abs(float(d.apply.float().mean()) - 0.5) < 0.02
    assert 0.4 <= float(d.a.min()) and float(d.a.max()) < 0.6
    assert abs(float(d.a.mean()) - 0.5) < 0.005
    counts = np.bincount(d.partner.numpy(), minlength=7) / 20000
    assert np.abs(counts - 1 / 7).max() < 0.01
    hits = np.zeros(16)
    for _ in range(2000):
        hits[ta.draw_effects(gen, 16, 0.75).rows.numpy()] += 1
    assert np.abs(hits / 2000 - 0.75).max() < 0.04
    c = ta.draw_cutout(gen, 20000, 0.25)
    assert abs(float(c.apply.float().mean()) - 0.25) < 0.02


def test_augmenter_switch_off_and_order():
    """None when every probability is 0; otherwise it runs with labels
    OR'd by MixUp and the chain's lengths, on a clean partner pool."""
    assert ta.make_augmenter(ta.AugmentConfig()) is None
    aug = ta.make_augmenter(ta.AugmentConfig(p_mixup=1.0, p_shuffle=0.5,
                                             p_aug=0.5))
    wave, lengths, labels = _batch(4, 65536, 12)
    gen = torch.Generator().manual_seed(1)
    w, n, y = aug(*_t(wave, lengths, labels), gen, 1.0)
    assert w.shape == wave.shape and torch.isfinite(w).all()
    assert (y.numpy() >= labels).all()
    assert (n.numpy() >= 1).all() and (n.numpy() <= 65536).all()


@pytest.mark.parametrize("field", ["p_flip", "p_cutout"])
def test_augmenter_runs_flip_and_cutout_when_asked(field):
    """At probability 1 through ``make_augmenter``: every row's valid region
    reversed, or every row loses at most a quarter of its valid length to
    zeros (the window clips at the buffer's end); lengths and labels stay."""
    aug = ta.make_augmenter(ta.AugmentConfig(**{field: 1.0}))
    wave, lengths, labels = _batch(4, 8000, 13)
    w, n, y = aug(*_t(wave, lengths, labels), torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(n.numpy(), lengths)
    np.testing.assert_array_equal(y.numpy(), labels)
    if field == "p_flip":
        want = ta.apply_flip(*_t(wave, lengths), torch.ones(4, dtype=bool))
        np.testing.assert_array_equal(w.numpy(), want.numpy())
        assert not np.array_equal(w.numpy(), wave)
    else:
        zeroed = ((w.numpy() == 0) & (wave != 0)).sum(axis=1)
        assert (zeroed >= 1).all()
        assert (zeroed <= (lengths * 0.25).astype(int)).all()
