"""The port's reference-compatible host API (``data/host_ops.py``,
``data/transforms.py``, ``data/sound_dataset.py``) against the JAX
package's, on the CPU (after ``tests/test_transforms_compat.py``).

Every host op and every transform draws from numpy's streams in JAX's
order, so under one seed both packages give the same arrays bit for bit and
leave the same stream behind. The effects chain is the exception: the port
draws its parameters with ``torch.Generator`` where JAX draws them with
``jax.random``, so the tests inject the parameters JAX draws from its key
(the 7-way split of ``augment.effects_chain``) and hold the outputs to the
tolerance of ``test_torch_augment.py::test_effects_chain_with_injected_
parameters``.
"""

import random

import jax
import numpy as np
import pytest
import torch

from freesound_classification_tpu.data import audio_io as jaudio
from freesound_classification_tpu.data import host_ops as jops
from freesound_classification_tpu.data import sound_dataset as jsd
from freesound_classification_tpu.data import transforms as jt
from freesound_classification_tpu_torch.data import host_ops as tops
from freesound_classification_tpu_torch.data import sound_dataset as tsd
from freesound_classification_tpu_torch.data import transforms as tt
from freesound_classification_tpu_torch.ops import dsp as tdsp

CLASS_MAP = {"A": 0, "B": 1, "C": 2}
LABELS = [["A"], ["B"], ["A", "C"], ["C"]]
CHAIN_SR = 8192


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


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    """Four 44.1 kHz clips: under a second (one shuffle chunk), 1.1 s, 2 s
    and 2.3 s (cropped to 1 s by ``SampleLongAudio(1)``)."""
    d = tmp_path_factory.mktemp("compat")
    rng = np.random.RandomState(0)
    files = []
    for i, n in enumerate([30000, 50000, 90000, 101234]):
        p = str(d / f"c{i}.wav")
        jaudio.write_wav(p, rng.randn(n) * 0.1, 44100)
        files.append(p)
    return files


def _same_state(a, b):
    """Two ``RandomState.get_state()`` tuples are the same stream."""
    return (a[0] == b[0] and np.array_equal(a[1], b[1])
            and a[2:] == b[2:])


def _both(fn_port, fn_jax, seed):
    """Each op from a fresh ``RandomState(seed)``: (port's, JAX's, whether
    the streams after them are the same)."""
    r_port, r_jax = np.random.RandomState(seed), np.random.RandomState(seed)
    got, want = fn_port(r_port), fn_jax(r_jax)
    return got, want, _same_state(r_port.get_state(), r_jax.get_state())


def _equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# host ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n1,n2", [(100, 300), (300, 100), (50, 50)])
@pytest.mark.parametrize("quirk", [True, False])
def test_mix_audio_and_labels_matches_jax(n1, n2, quirk):
    rng = np.random.RandomState(1)
    a, b = (rng.randn(n1).astype("f4"), rng.randn(n2).astype("f4"))
    la, lb = np.array([1, 0, 1], "f4"), np.array([0, 1, 1], "f4")
    got, want, same = _both(
        lambda r: tops.mix_audio_and_labels(a, b, la, lb, rng=r,
                                            quirk_replace=quirk),
        lambda r: jops.mix_audio_and_labels(a, b, la, lb, rng=r,
                                            quirk_replace=quirk), 7)
    _equal(got, want)
    assert same


@pytest.mark.parametrize("n,sr", [(44100 * 2, 44100), (44100 * 3 + 17, 44100),
                                  (30000, 44100), (9000, 8192)])
def test_shuffle_audio_matches_jax(n, sr):
    x = np.random.RandomState(2).randn(n).astype("f4")
    got, want, same = _both(
        lambda r: tops.shuffle_audio(x, 0.5, sr=sr, rng=r),
        lambda r: jops.shuffle_audio(x, 0.5, sr=sr, rng=r), 3)
    _equal(got, want)
    assert same


@pytest.mark.parametrize("n,area", [(1000, 0.25), (30001, 0.1), (7, 0.5)])
def test_cutout_matches_jax(n, area):
    x = np.random.RandomState(4).randn(n).astype("f4")
    got, want, same = _both(lambda r: tops.cutout(x, area, rng=r),
                            lambda r: jops.cutout(x, area, rng=r), 5)
    _equal(got, want)
    assert same and (got == 0).any()


def test_ops_draw_from_the_global_stream_without_an_rng():
    """``rng=None`` draws from ``np.random`` in JAX's order."""
    x = np.random.RandomState(6).randn(44100 * 2).astype("f4")
    y = x[:20000].copy()
    outs, states = [], []
    for ops in (tops, jops):
        np.random.seed(11)
        outs.append((ops.shuffle_audio(x), ops.cutout(x),
                     ops.mix_audio_and_labels(x, y, np.ones(2, "f4"),
                                              np.zeros(2, "f4"))))
        states.append(np.random.get_state())
    _equal(outs[0], outs[1])
    assert _same_state(*states)


@pytest.mark.parametrize("case", ["silence around a tone", "all quiet",
                                  "short", "empty"])
def test_trim_audio_and_even_slices_match_jax(case):
    x = {"silence around a tone": np.concatenate([
        np.zeros(10000, "f4"),
        np.sin(np.linspace(0, 100, 30000)).astype("f4"),
        np.zeros(7000, "f4")]),
        "all quiet": np.full(9000, 1e-6, "f4"),
        "short": np.random.RandomState(8).randn(700).astype("f4"),
        "empty": np.zeros(0, "f4")}[case]
    _equal(tops.trim_audio(x), jops.trim_audio(x))
    for size, n in ((10, 3), (88200, 4), (5, 5), (len(x) + 1, 2)):
        _equal(tops.gen_even_slices_sizes(size, n),
               jops.gen_even_slices_sizes(size, n))


@pytest.mark.parametrize("window,hop,log", [(512, 256, True),
                                            (2048, 1024, True),
                                            (1024, 256, False)])
def test_compute_stft_matches_jax(window, hop, log):
    x = np.random.RandomState(9).randn(20000).astype("f4") * 0.1
    got = tops.compute_stft(x, window, hop, log=log)
    want = jops.compute_stft(x, window, hop, log=log)
    assert got.shape == want.shape == (window // 2 + 1, got.shape[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the effects chain
# ---------------------------------------------------------------------------


def _jax_chain_parameters(seed):
    """The five parameters JAX's chain draws for one row from
    ``PRNGKey(seed)`` (``augment.effects_chain``'s 7-way split)."""
    _, k_rev, k_room, k_pitch, k_gain, k_speed, _ = jax.random.split(
        jax.random.PRNGKey(seed), 7)
    return [float(np.asarray(jax.random.uniform(k, (1,), minval=lo,
                                                maxval=hi))[0])
            for k, lo, hi in ((k_rev, 0.0, 50.0), (k_room, 0.0, 50.0),
                              (k_pitch, -300.0, 300.0), (k_gain, 2.0, 10.0),
                              (k_speed, 0.9, 1.1))]


@pytest.mark.parametrize("n", [7000, 7001, 8191, 12345, 3000])
def test_effects_chain_with_injected_parameters(n):
    """JAX's host chain against the port's on JAX's parameters, at the
    buffers 16384 and (n = 3000) 4096, where the phase vocoder takes n_fft
    512 and hop 128: the same new length, correlation above 0.999 and
    relative error under 5e-2 (the augment test's tolerance); and the
    port's own ``apply_effects_chain`` leaves numpy's stream where JAX's
    does."""
    audio = (np.random.RandomState(n).randn(n) * 0.1).astype("f4")
    r_jax, r_port = np.random.RandomState(n), np.random.RandomState(n)
    seed = int(np.random.RandomState(n).randint(0, 2**31 - 1))
    want = jops.apply_effects_chain(audio, sr=CHAIN_SR, rng=r_jax)
    got = tops.effects_chain_with(audio, *_jax_chain_parameters(seed),
                                  sr=CHAIN_SR, device="cpu")
    assert tops.effects_buffer(n) == (4096 if n == 3000 else 16384)
    assert got.dtype == np.float32 and got.shape == want.shape
    corr = np.corrcoef(got, want)[0, 1]
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert corr > 0.999 and rel < 5e-2, (corr, rel)
    own = tops.apply_effects_chain(audio, sr=CHAIN_SR, rng=r_port,
                                   device="cpu")
    assert np.isfinite(own).all() and 0.5 * n < own.size <= 2.5 * n
    assert _same_state(r_port.get_state(), r_jax.get_state())


def test_chain_over_varied_lengths_caches_one_iir_entry_per_buffer():
    """Each clip length pads to a power-of-two buffer, and
    ``dsp.iir_matrices`` keeps one entry per (buffer, device): eight clip
    lengths over two buffers add at most two entries."""
    before = tdsp.iir_matrices.cache_info().currsize
    rng = np.random.RandomState(12)
    for n in (2000, 2500, 3000, 3276, 7000, 9000, 11000, 13000):
        tops.apply_effects_chain(
            (rng.randn(n) * 0.1).astype("f4"), sr=CHAIN_SR, rng=rng,
            device="cpu")
    assert tdsp.iir_matrices.cache_info().currsize - before <= 2
    assert {tops.effects_buffer(n) for n in (2000, 3276)} == {4096}
    assert {tops.effects_buffer(n) for n in (3277, 13107)} == {8192, 16384}


def test_audio_augmentation_needs_a_device():
    """The card by default: without one the constructor raises, naming the
    way to the CPU; ``device="cpu"`` runs the chain there."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.AudioAugmentation(p=1.0)
    aug = tt.AudioAugmentation(p=1.0, device="cpu")
    np.random.seed(0)
    out = aug(audio=np.random.randn(5000).astype("f4") * 0.1, sr=CHAIN_SR)
    assert out["audio"].dtype == np.float32 and np.isfinite(
        out["audio"]).all()


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------


def _reference_stack(m, aug=None):
    """The transform stack of reference ``train_2d_cnn.py:310-322`` in
    module ``m``, with ``aug`` (an ``AudioAugmentation``) after MixUp."""
    train = [m.LoadAudio(), m.SampleLongAudio(max_length=1),
             m.MapLabels(class_map=CLASS_MAP),
             m.ShuffleAudio(chunk_length=0.5, p=0.5), m.MixUp(p=0.5)]
    train += [aug] if aug is not None else []
    train += [m.AudioFeatures("mel_2048_1024_128"),
              m.DropFields(("audio", "filename", "sr"))]
    clean = [m.LoadAudio(), m.SampleLongAudio(max_length=1),
             m.MapLabels(class_map=CLASS_MAP)]
    return m.Compose(train), m.Compose(clean)


def _other_stack(m):
    return m.Compose([
        m.LoadAudio(), m.OneOf([m.FlipAudio(p=1.0), m.Identity()]),
        m.SampleSegment(ratio=(0.3, 0.9), p=0.7),
        m.CutOut(area=0.25, p=0.5),
        m.OneOf([m.STFT(n_fft=512, hop_size=256),
                 m.STFT(n_fft=1024, hop_size=128)]),
        m.RenameFields({"stft": "signal"}),
        m.DropFields(("filename", "audio"))])


def _samples(dataset_cls, stack, files, seed, epochs=2):
    """Every sample of ``epochs`` passes over the dataset after
    ``np.random.seed(seed)`` and ``random.seed(seed)``, and the two
    streams' states after them."""
    transform, clean = stack
    ds = dataset_cls(audio_files=files, labels=LABELS, transform=transform,
                     clean_transform=clean)
    np.random.seed(seed)
    random.seed(seed)
    out = [ds[i] for _ in range(epochs) for i in range(len(ds))]
    return out, np.random.get_state(), random.getstate()


@pytest.mark.parametrize("stack", ["reference train", "segment and stft"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipelines_give_jax_samples(wav_files, stack, seed):
    """Under the same seeds the port's pipeline over its ``SoundDataset``
    gives the JAX pipeline's samples bit for bit, key by key, and leaves
    numpy's and ``random``'s streams where JAX's leaves them."""
    def build(m):
        return (_reference_stack(m) if stack == "reference train"
                else (_other_stack(m), None))

    got, np_got, py_got = _samples(tsd.SoundDataset, build(tt), wav_files,
                                   seed)
    want, np_want, py_want = _samples(jsd.SoundDataset, build(jt), wav_files,
                                      seed)
    assert len(got) == len(want) == 2 * len(wav_files)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            _equal(g[k], w[k])
    assert _same_state(np_got, np_want) and py_got == py_want
    if stack == "reference train":
        assert all(s["signal"].shape[1] == 1
                   and s["signal"].shape[0] <= 44100 for s in got)


def test_reference_stack_with_the_chain_keeps_jax_streams(wav_files,
                                                          monkeypatch):
    """With ``AudioAugmentation(p=0.5)`` after MixUp (the port's on the
    CPU): numpy's and ``random``'s streams end where JAX's do, every
    sample has JAX's keys and labels, the chain runs on the same samples,
    and the samples it left alone are JAX's bit for bit."""
    ran = []
    chain = tops.apply_effects_chain

    def recording(*args, **kwargs):
        ran[-1] = True
        return chain(*args, **kwargs)

    monkeypatch.setattr(tops, "apply_effects_chain", recording)
    samples, states = [], []
    for m, aug in ((tt, tt.AudioAugmentation(p=0.5, device="cpu")),
                   (jt, jt.AudioAugmentation(p=0.5))):
        transform, clean = _reference_stack(m, aug)
        ds = (tsd if m is tt else jsd).SoundDataset(
            audio_files=wav_files, labels=LABELS, transform=transform,
            clean_transform=clean)
        np.random.seed(5)
        random.seed(5)
        out = []
        for i in range(len(ds)):
            ran.append(False)
            out.append(ds[i])
        samples.append(out)
        states.append((np.random.get_state(), random.getstate()))
    assert _same_state(states[0][0], states[1][0])
    assert states[0][1] == states[1][1]
    ran = ran[:len(wav_files)]
    assert any(ran) and not all(ran), ran
    for g, w, chained in zip(*samples, ran):
        assert set(g) == set(w)
        _equal(g["labels"], w["labels"])
        assert g["signal"].dtype == np.float32
        assert np.isfinite(g["signal"]).all()
        if not chained:
            _equal(g["signal"], w["signal"])


def test_descriptors_switch_off_and_oneof(wav_files):
    for descriptor in ("mel_2048_1024_128", "stft_1024_256", "raw"):
        got, want = tt.AudioFeatures(descriptor), jt.AudioFeatures(descriptor)
        assert (got.feature_type, got.n_features, got.padding_value) == (
            want.feature_type, want.n_features, want.padding_value)
    mix, shuf, cut = tt.MixUp(p=1.0), tt.ShuffleAudio(p=1.0), tt.CutOut(p=1.0)
    aug = tt.AudioAugmentation(p=1.0, device="cpu")
    c = tt.Compose([tt.LoadAudio(), tt.MapLabels(CLASS_MAP), shuf, mix, aug,
                    cut])
    c.switch_off_augmentations()
    assert mix.p == shuf.p == cut.p == aug.p == 0.0
    out = c(dataset=None, filename=wav_files[0], raw_labels=["A"])
    audio, sr = jaudio.read_wav(wav_files[0])
    assert sr == out["sr"] == 44100
    _equal(out["audio"], audio)
    assert tt.OneOf([tt.Identity(), tt.Identity()])(dataset=None, x=1) == {
        "x": 1}
