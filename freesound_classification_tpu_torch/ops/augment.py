"""On-device audio augmentations of the train step (JAX ``ops/augment.py``).

Every op is a function of (waveform batch (B, L), valid lengths (B,), ...)
with static shapes. Its random draws come from an explicit
``torch.Generator`` through a ``draw_*`` function, and ``apply_*`` takes the
drawn values, so tests can inject them. The JAX package draws from
``jax.random`` keys; the two give different numbers from one seed, so the
ops are compared on injected draws and the draws on their distributions.

- ``shuffle_chunks``: permute the full 0.5 s chunks of the valid region
- ``flip``: reverse the valid region
- ``mixup_or``: MixUp with OR'd labels and the reference's window
  *replacement* quirk (``quirk_replace``); partners come from a pool of
  clean clips
- ``cutout``: zero a random 25% window
- ``effects_chain``: reverb -> phase-vocoder stretch 1/f -> overdrive ->
  resample by speed * f (f = 2^(cents/1200)), on round(p * B) chosen rows;
  the stretch runs K3 and the resample K2
- ``sample_segment``: crop a random sub-segment of the valid region to the
  row's start
- ``tta_perturb``: the test-time perturbation, a random right shift and
  white noise below each clip's RMS
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from freesound_classification_tpu_torch.ops import freeverb, kernels, pv
from freesound_classification_tpu_torch.ops.dsp import iir_first_order
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib

SR = 44100

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _uniform(gen: torch.Generator, n: int, low: float = 0.0,
             high: float = 1.0) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=gen.device)
    return low + (high - low) * u


def _bernoulli(gen: torch.Generator, n: int, p: float) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=gen.device) < min(max(p, 0.0),
                                                                 1.0)


def _positions(wave: torch.Tensor) -> torch.Tensor:
    return torch.arange(wave.shape[1], device=wave.device)[None, :]


def _shift_rows(wave: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """out[b, i] = wave[b, (i - shift[b]) mod L]."""
    src = (_positions(wave) - shift[:, None].long()) % wave.shape[1]
    return torch.gather(wave, 1, src)


# ---------------------------------------------------------------------------
# chunk shuffle
# ---------------------------------------------------------------------------


class ShuffleDraws(NamedTuple):
    apply: torch.Tensor  # (B,) bool
    keys: torch.Tensor  # (B, n_chunks) uniform sort keys


def draw_shuffle_chunks(gen: torch.Generator, b: int, l: int, p: float,
                        chunk_seconds: float = 0.5,
                        sr: int = SR) -> ShuffleDraws:
    n_chunks = l // max(int(chunk_seconds * sr), 1)
    return ShuffleDraws(_bernoulli(gen, b, p),
                        torch.rand(b, n_chunks, generator=gen,
                                   device=gen.device))


def apply_shuffle_chunks(wave: torch.Tensor, lengths: torch.Tensor,
                         d: ShuffleDraws, chunk_seconds: float = 0.5,
                         sr: int = SR) -> torch.Tensor:
    """Permute the full chunks inside the valid region of rows with at least
    two of them; the partial tail chunk and the padding stay in place."""
    b, l = wave.shape
    chunk = max(int(chunk_seconds * sr), 1)
    c_total = l // chunk
    if c_total < 2:
        return wave
    n_full = torch.clamp(lengths.long() // chunk, max=c_total)
    idx = torch.arange(c_total, device=wave.device)[None, :]
    # valid chunks get random sort keys, the rest ascending keys above them
    keys = torch.where(idx < n_full[:, None], d.keys, 2.0 + idx)
    perm = torch.argsort(keys, dim=1, stable=True)
    head = wave[:, : c_total * chunk].reshape(b, c_total, chunk)
    shuffled = torch.gather(head, 1, perm[:, :, None].expand(-1, -1, chunk))
    shuffled = torch.cat([shuffled.reshape(b, -1), wave[:, c_total * chunk:]],
                         dim=1)
    use = (d.apply & (n_full >= 2))[:, None]
    return torch.where(use, shuffled, wave)


# ---------------------------------------------------------------------------
# flip and cutout
# ---------------------------------------------------------------------------


def apply_flip(wave: torch.Tensor, lengths: torch.Tensor,
               apply: torch.Tensor) -> torch.Tensor:
    """Reverse the valid region of the rows where ``apply`` holds."""
    idx = _positions(wave)
    n = lengths.long()[:, None]
    rev = torch.clamp(n - 1 - idx, 0, wave.shape[1] - 1)
    flipped = torch.gather(wave, 1, torch.where(idx < n, rev, idx))
    return torch.where(apply[:, None], flipped, wave)


class CutoutDraws(NamedTuple):
    apply: torch.Tensor  # (B,) bool
    start: torch.Tensor  # (B,) uniform in [0, 1)


def draw_cutout(gen: torch.Generator, b: int, p: float) -> CutoutDraws:
    return CutoutDraws(_bernoulli(gen, b, p), _uniform(gen, b))


def apply_cutout(wave: torch.Tensor, lengths: torch.Tensor, d: CutoutDraws,
                 area: float = 0.25) -> torch.Tensor:
    """Zero ``area`` x the valid length from a uniform start (clipped at the
    buffer's end)."""
    n = lengths.float()
    width = (n * area).to(torch.int32)
    start = (d.start * n).to(torch.int32)
    idx = _positions(wave)
    window = (idx >= start[:, None]) & (idx < (start + width)[:, None])
    return torch.where(window & d.apply[:, None], 0.0, wave)


class SegmentDraws(NamedTuple):
    apply: torch.Tensor  # (B,) bool
    ratio: torch.Tensor  # (B,) U(ratio)
    start: torch.Tensor  # (B,) uniform in [0, 1)


def draw_sample_segment(gen: torch.Generator, b: int, p: float,
                        ratio=(0.3, 0.9)) -> SegmentDraws:
    return SegmentDraws(_bernoulli(gen, b, p), _uniform(gen, b, *ratio),
                        _uniform(gen, b))


def apply_sample_segment(wave: torch.Tensor, lengths: torch.Tensor,
                         d: SegmentDraws):
    """Keep a random sub-segment of ``ratio`` x the valid length, moved to
    the row's start, on the rows where ``d.apply`` holds (JAX
    ``augment.sample_segment``); returns (wave, lengths)."""
    new_len = torch.clamp(lengths.float() * d.ratio, min=1.0).to(
        torch.int32)
    span = torch.clamp(lengths - new_len, min=1)
    start = (d.start * span).to(torch.int32)
    shifted = _shift_rows(wave, -start)
    cropped = torch.where(_positions(wave) < new_len[:, None], shifted, 0.0)
    return (torch.where(d.apply[:, None], cropped, wave),
            torch.where(d.apply, new_len, lengths).to(lengths.dtype))


# ---------------------------------------------------------------------------
# MixUp-OR
# ---------------------------------------------------------------------------


class MixupDraws(NamedTuple):
    partner: torch.Tensor  # (B,) int64 row of the partner pool
    apply: torch.Tensor  # (B,) bool
    a: torch.Tensor  # (B,) U(0.4, 0.6)
    start: torch.Tensor  # (B,) uniform in [0, 1)


def draw_mixup(gen: torch.Generator, b: int, pool_size: int,
               p: float) -> MixupDraws:
    partner = torch.randint(0, pool_size, (b,), generator=gen,
                            device=gen.device)
    return MixupDraws(partner, _bernoulli(gen, b, p),
                      _uniform(gen, b, 0.4, 0.6), _uniform(gen, b))


def apply_mixup_or(wave: torch.Tensor, lengths: torch.Tensor,
                   labels: torch.Tensor, d: MixupDraws,
                   partner: Optional[Batch] = None,
                   quirk_replace: bool = True) -> Batch:
    """Mix each applied row with its drawn partner: the shorter clip goes
    into a random window of the longer, which is scaled by a; labels are
    OR'd. ``quirk_replace`` replaces the window by ``shorter * (1 - a)``
    (the reference's ``=+``), else adds it. Equal lengths give the plain
    average. ``partner`` is the clean pool (default: this batch)."""
    src_wave, src_len, src_lab = (partner if partner is not None
                                  else (wave, lengths, labels))
    wave2, len2, lab2 = (src_wave[d.partner], src_len[d.partner],
                         src_lab[d.partner])
    first_longer = lengths >= len2
    longer = torch.where(first_longer[:, None], wave, wave2)
    shorter = torch.where(first_longer[:, None], wave2, wave)
    longer_len = torch.maximum(lengths, len2)
    shorter_len = torch.minimum(lengths, len2)
    span = torch.clamp(longer_len - shorter_len, min=1)
    start = (d.start * span).to(torch.int32)
    # start <= L - shorter_len, so the roll never wraps into the window
    shifted = _shift_rows(shorter, start)
    idx = _positions(wave)
    window = (idx >= start[:, None]) & (idx < (start + shorter_len)[:, None])
    a = d.a[:, None]
    scaled_longer = longer * a
    inserted = shifted * (1.0 - a)
    if quirk_replace:
        mixed = torch.where(window, inserted, scaled_longer)
    else:
        mixed = scaled_longer + torch.where(window, inserted, 0.0)
    equal = (lengths == len2)[:, None]
    mixed = torch.where(equal, (wave + wave2) * 0.5, mixed)
    new_labels = torch.clamp(labels + lab2, 0.0, 1.0)
    apply = d.apply
    return (torch.where(apply[:, None], mixed, wave),
            torch.where(apply, longer_len, lengths).to(lengths.dtype),
            torch.where(apply[:, None], new_labels, labels))


# ---------------------------------------------------------------------------
# effects chain
# ---------------------------------------------------------------------------


def overdrive(wave: torch.Tensor, gain_db: torch.Tensor,
              colour: float = 20.0) -> torch.Tensor:
    """sox ``overdrive gain colour`` (sox 14.4.2 src/overdrive.c):
    d = x 10^(gain/20) + colour/200, soft-clipped to d - d^3/3 inside
    [-1, 1] (+-2/3 outside); y[n] = d[n] - d[n-1] + 0.995 y[n-1];
    out = clip(x/2 + 3/4 y, -1, 1). The DC-blocking recurrence runs in full
    float32 (``dsp.iir_first_order``)."""
    g = torch.pow(10.0, gain_db / 20.0)
    d = wave * g[:, None] + colour / 200.0
    d = torch.where(d < -1.0, -2.0 / 3.0,
                    torch.where(d > 1.0, 2.0 / 3.0, d - d * d * d * (1 / 3)))
    u = d - torch.nn.functional.pad(d[:, :-1], (1, 0))
    y = iir_first_order(u, 0.995)
    return torch.clamp(wave * 0.5 + y * 0.75, -1.0, 1.0)


def resample_rate(wave: torch.Tensor, lengths: torch.Tensor,
                  factor: torch.Tensor):
    """Playback-rate change by per-row ``factor`` (> 1: faster, shorter;
    sox ``speed``) through K2, in the same buffer: source positions at or
    past the valid length read 0 (K2's mask, in its store), and the valid
    length becomes ``min(int(length / factor), L)``."""
    l = wave.shape[1]
    factor = factor.float().contiguous()
    out = kernels.resample_linear(wave.float().contiguous(), factor, lengths)
    new_len = torch.clamp((lengths.float() / factor).to(torch.int32), max=l)
    return out, torch.clamp(new_len, min=1).to(lengths.dtype)


class EffectsDraws(NamedTuple):
    rows: torch.Tensor  # (k,) int64 rows that take the chain
    reverberance: torch.Tensor  # (B,) U(0, 50)
    room: torch.Tensor  # (B,) U(0, 50)
    cents: torch.Tensor  # (B,) U(-300, 300)
    gain: torch.Tensor  # (B,) U(2, 10)
    speed: torch.Tensor  # (B,) U(0.9, 1.1)


def effects_count(b: int, p: float, shard: Optional[Tuple[int, int]] = None
                  ) -> int:
    """How many of a batch's ``b`` rows take the chain at probability
    ``0 < p < 1`` (JAX ``augment.py:447-448``): ``k = round(p * B)`` of the
    global batch's B rows, at least 1. On rank r of ``shard`` = (r, world),
    ``b`` is the rank's slice of the global batch of ``b * world`` rows,
    and the rank takes its part of k as the loader splits rows
    (``mesh.rank_rows``: ceil(k / world) each, the rest on the last
    ranks), so the ranks' counts sum to k."""
    rank, world = shard if shard is not None else (0, 1)
    n = b * world
    k = max(1, min(n, int(round(n * p))))
    return mesh_lib.rank_rows(k, rank, world)[1]


def draw_effects(gen: torch.Generator, b: int, p: float,
                 shard: Optional[Tuple[int, int]] = None) -> EffectsDraws:
    """The chain's rows and parameters (ranges of the reference chain,
    transforms.py:94-105). The chain runs on exactly round(p * B) rows
    chosen uniformly (fixed-count compaction): each row's probability is
    round(p * B) / B, exactly p when p * B is whole (0.75 * 64 = 48). On a
    rank of ``shard``, B is the global batch and the rank's rows are its
    share of that count (``effects_count``), chosen uniformly among its
    own."""
    world = shard[1] if shard is not None else 1
    if 0.0 < p < 1.0 and b * world > 1:
        k = effects_count(b, p, shard)
        rows = torch.randperm(b, generator=gen, device=gen.device)[:k]
    elif p >= 1.0:
        rows = torch.arange(b, device=gen.device)
    else:
        rows = torch.nonzero(_bernoulli(gen, b, p))[:, 0]
    return EffectsDraws(rows, _uniform(gen, b, 0.0, 50.0),
                        _uniform(gen, b, 0.0, 50.0),
                        _uniform(gen, b, -300.0, 300.0),
                        _uniform(gen, b, 2.0, 10.0),
                        _uniform(gen, b, 0.9, 1.1))


def run_chain(wave: torch.Tensor, lengths: torch.Tensor,
              reverberance: torch.Tensor, room: torch.Tensor,
              cents: torch.Tensor, gain: torch.Tensor, speed: torch.Tensor,
              sr: int = SR):
    """reverb -> PV stretch by 1/f -> overdrive -> resample by speed * f,
    f = 2^(cents/1200): pitch x f at the clip's duration / speed."""
    l = wave.shape[1]
    out, new_len = freeverb.reverb_batch(wave, lengths, reverberance, room,
                                         sr)
    pitch_factor = torch.exp2(cents / 1200.0)
    n_fft = min(1024, max(256, l // 8))
    out, new_len = pv.phase_vocoder_stretch(out, new_len, 1.0 / pitch_factor,
                                            n_fft=n_fft, hop=n_fft // 4)
    out = overdrive(out, gain)
    return resample_rate(out, new_len, speed * pitch_factor)


def apply_effects(wave: torch.Tensor, lengths: torch.Tensor,
                  d: EffectsDraws, sr: int = SR):
    """Run the chain on the rows ``d.rows`` (gathered, then scattered
    back); the other rows pass through."""
    if d.rows.numel() == 0:
        return wave, lengths
    rows = d.rows
    out, new_len = run_chain(wave[rows], lengths[rows],
                             d.reverberance[rows], d.room[rows],
                             d.cents[rows], d.gain[rows], d.speed[rows], sr)
    wave = wave.clone()
    lengths = lengths.clone()
    wave[rows] = out
    lengths[rows] = new_len.to(lengths.dtype)
    return wave, lengths


# ---------------------------------------------------------------------------
# test-time perturbation
# ---------------------------------------------------------------------------


class TTADraws(NamedTuple):
    shift: Optional[torch.Tensor]  # (B,) int64 in [0, max shift], or None
    noise: Optional[torch.Tensor]  # (B, L) standard normal, or None


def draw_tta_perturb(gen: torch.Generator, b: int, l: int,
                     noise_snr_db: float = 0.0, shift_max_s: float = 0.0,
                     sr: int = SR) -> TTADraws:
    shift = noise = None
    if shift_max_s > 0.0:
        max_shift = max(int(shift_max_s * sr), 1)
        shift = torch.randint(0, max_shift + 1, (b,), generator=gen,
                              device=gen.device)
    if noise_snr_db > 0.0:
        noise = torch.randn(b, l, generator=gen, device=gen.device)
    return TTADraws(shift, noise)


def apply_tta_perturb(wave: torch.Tensor, lengths: torch.Tensor,
                      d: TTADraws, noise_snr_db: float = 0.0):
    """A light perturbation of an inference batch (JAX
    ``augment.tta_perturb``): each row's content shifted right by
    ``d.shift`` samples into its padding (what passes the buffer's end is
    dropped), then white noise ``noise_snr_db`` dB below the row's RMS over
    its valid samples, on those samples only. Returns (wave, lengths)."""
    out, out_len = wave, lengths
    idx = _positions(wave)
    if d.shift is not None:
        end = torch.clamp(out_len.long() + d.shift, max=wave.shape[1])
        keep = (idx >= d.shift[:, None]) & (idx < end[:, None])
        out = torch.where(keep, _shift_rows(out, d.shift), 0.0)
        out_len = end.to(lengths.dtype)
    if d.noise is not None:
        valid = (idx < out_len[:, None]).to(out.dtype)
        rms = torch.sqrt((out * out * valid).sum(dim=1)
                         / torch.clamp(out_len.to(out.dtype), min=1.0))
        sigma = rms * 10.0 ** (-noise_snr_db / 20.0)
        out = out + d.noise * sigma[:, None] * valid
    return out, out_len


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


class AugmentConfig(NamedTuple):
    p_mixup: float = 0.0
    p_aug: float = 0.0  # effects chain
    p_shuffle: float = 0.0  # 0.5 for non-rnn models
    p_cutout: float = 0.0
    p_flip: float = 0.0
    mixup_quirk_replace: bool = True
    sr: int = SR


def make_augmenter(cfg: AugmentConfig):
    """fn(wave, lengths, labels, gen, scale, partner=None) -> (wave,
    lengths, labels) in the reference order shuffle -> flip -> mixup ->
    effects -> cutout, or None when every probability is 0. ``scale``
    multiplies every probability (the epoch switch-off passes 0 and the
    engine then skips the call). ``partner`` is the pool of clean clips for
    MixUp; None mixes with a clean copy of the batch itself. ``shard`` =
    (rank, world) marks the batch as a rank's slice of a global batch: the
    effects chain then runs on the rank's share of the global count
    (``effects_count``), and MixUp partners come from the rank's own
    ``partner`` rows (JAX's pool is the global batch)."""
    if not any((cfg.p_mixup, cfg.p_aug, cfg.p_shuffle, cfg.p_cutout,
                cfg.p_flip)):
        return None

    def augment(wave, lengths, labels, gen, scale=1.0, partner=None,
                shard=None):
        b, l = wave.shape
        clean = partner if partner is not None else (wave, lengths, labels)
        if cfg.p_shuffle:
            wave = apply_shuffle_chunks(
                wave, lengths,
                draw_shuffle_chunks(gen, b, l, cfg.p_shuffle * scale,
                                    sr=cfg.sr), sr=cfg.sr)
        if cfg.p_flip:
            wave = apply_flip(wave, lengths,
                              _bernoulli(gen, b, cfg.p_flip * scale))
        if cfg.p_mixup:
            wave, lengths, labels = apply_mixup_or(
                wave, lengths, labels,
                draw_mixup(gen, b, clean[0].shape[0], cfg.p_mixup * scale),
                partner=clean, quirk_replace=cfg.mixup_quirk_replace)
        if cfg.p_aug:
            wave, lengths = apply_effects(
                wave, lengths,
                draw_effects(gen, b, cfg.p_aug * scale, shard), sr=cfg.sr)
        if cfg.p_cutout:
            wave = apply_cutout(wave, lengths,
                                draw_cutout(gen, b, cfg.p_cutout * scale))
        return wave, lengths, labels

    return augment
