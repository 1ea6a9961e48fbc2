"""The plain reference against the port's CPU path (the kernels' plain
twins) at a tiny size, float32: the model, the loss, the gradients and
Adam's update, the fold ensemble, and the augmentation stage by stage."""

from __future__ import annotations

import pytest
import torch

from port_bench import spec
from port_bench.reference import augment as ref_augment
from pb_tiny import run_tiny

SR = 44100


@pytest.mark.parametrize("config", sorted(
    p.stem for p in (spec.BENCH_DIR / "configs").glob("*.json")))
def test_train_steps_match(config, data_root):
    """Without augmentation the port's first steps read as the reference's
    (every configuration in the train cell): the median leaf's
    first gradient to float32 rounding. Adam's update moves a weight whose
    gradient is rounding alone by a whole step, so the change after three
    steps agrees less closely."""
    out = run_tiny("melcnn2d.train_noaug", data_root, config=config)
    assert out["correct"]
    assert out["check"]["grad_gap_median"][0] < 1e-3


def test_ensemble_matches(data_root):
    out = run_tiny("melcnn2d.infer_5fold", data_root)
    assert out["correct"] and out["check"]["prob_gap"][0] < 1e-5
    assert out["attempted"] >= 20 and out["failed"] == 0


@pytest.fixture
def batch():
    gen = torch.Generator().manual_seed(0)
    wave = 0.1 * torch.randn(4, 88064, generator=gen)
    lengths = torch.tensor([88064, 50000, 70000, 30000], dtype=torch.int32)
    wave = wave * (torch.arange(88064)[None] < lengths[:, None])
    labels = (torch.rand(4, 10, generator=gen) < 0.2).float()
    return wave, lengths, labels


def test_augmentation_matches_stage_by_stage(batch):
    """Shuffle, MixUp and the resample are exact; the reverb and overdrive
    agree to float32 rounding; the phase-vocoder stretch to 2 % of the
    clip's peak: the port synthesizes in bf16 and carries phases in float32
    tiles (K3's design), the reference in float32 and float64."""
    from freesound_classification_tpu_torch.ops import augment, freeverb, pv

    wave, lengths, labels = batch
    g = torch.Generator().manual_seed(3)
    d = augment.draw_shuffle_chunks(g, 4, wave.shape[1], 1.0)
    assert torch.equal(augment.apply_shuffle_chunks(wave, lengths, d),
                       ref_augment.shuffle_chunks(wave, lengths, *d))
    dm = augment.draw_mixup(g, 4, 4, 1.0)
    partner = (wave.flip(0), lengths.flip(0), labels.flip(0))
    for got, want in zip(augment.apply_mixup_or(wave, lengths, labels, dm,
                                                partner=partner),
                         ref_augment.mixup(wave, lengths, labels, tuple(dm),
                                           partner)):
        assert torch.equal(got, want)
    rv, room = 50 * torch.rand(4, generator=g), 50 * torch.rand(4, generator=g)
    got, got_n = freeverb.reverb_batch(wave, lengths, rv, room, SR)
    want, want_n = ref_augment.reverb(wave, lengths, rv, room)
    assert (got - want).abs().max() < 1e-6 and torch.equal(got_n, want_n)
    rate = 1.0 / torch.exp2((600 * torch.rand(4, generator=g) - 300) / 1200)
    got, got_n = pv.phase_vocoder_stretch(wave, lengths, rate, 1024, 256)
    want, want_n = ref_augment.stretch(wave, lengths, rate, 1024, 256)
    assert (got - want).abs().max() < 0.02 * want.abs().max()
    assert torch.equal(got_n, want_n)
    gain = 2 + 8 * torch.rand(4, generator=g)
    assert (augment.overdrive(wave, gain)
            - ref_augment.overdrive(wave, gain)).abs().max() < 1e-5
    f = 0.8 + 0.4 * torch.rand(4, generator=g)
    got, got_n = augment.resample_rate(wave, lengths, f)
    want, want_n = ref_augment.resample(wave, lengths, f)
    assert torch.equal(got, want) and torch.equal(got_n, want_n)


def test_same_seed_same_draws(batch):
    """One seed gives the port's augmenter and the reference's the same
    draws: the lengths and labels come out equal, the waves within the
    stretch's difference."""
    from freesound_classification_tpu_torch.ops import augment

    wave, lengths, labels = batch
    fn = augment.make_augmenter(augment.AugmentConfig(
        p_mixup=0.5, p_aug=0.75, p_shuffle=0.5))
    partner = (wave.flip(0), lengths.flip(0), labels.flip(0))
    got = fn(wave, lengths, labels, torch.Generator().manual_seed(5), 1.0,
             partner=partner)
    want = ref_augment.augment(
        wave, lengths, labels, torch.Generator().manual_seed(5),
        {"p_mixup": 0.5, "p_aug": 0.75, "p_shuffle": 0.5}, 1.0, partner)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert (got[0] - want[0]).abs().max() < 0.02 * want[0].abs().max()
