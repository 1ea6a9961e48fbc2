"""The recipe's train-time augmentation (the reference's ``transforms.py``
chain as the port runs it on the device), drawn from a seeded
``torch.Generator`` in the port's order of draws so that one seed gives
both sides the same draws, and applied plainly:

shuffle the full 0.5 s chunks of the valid region (p_shuffle) -> MixUp with
OR'd labels (p_mixup; the shorter clip *replaces* a random window of the
longer one scaled by a, a ~ U(0.4, 0.6): the reference's ``=+`` quirk;
equal lengths average) -> the effects chain on round(p_aug * B) rows:
sox reverb (freeverb's combs and allpasses as their transfer function) ->
phase-vocoder stretch by 1/f -> sox overdrive -> linear resample by
speed * f, f = 2^(cents / 1200).

Counts and positions that decide lengths stay in float32, as the recipe's
float32 pipeline has them; the filters run in float64 where that is cheap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SR = 44100
COMBS = np.array([1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617])
ALLPASSES = np.array([225, 341, 441, 556])


def _u(gen, n, low=0.0, high=1.0):
    return low + (high - low) * torch.rand(n, generator=gen,
                                           device=gen.device)


def _bern(gen, n, p):
    return torch.rand(n, generator=gen, device=gen.device) < min(max(p, 0.0),
                                                                 1.0)


def draw(gen: torch.Generator, b: int, l: int, aug: dict, scale: float,
         pool: int) -> dict:
    """Every draw of one augmented batch, in the port's order."""
    d = {}
    if aug["p_shuffle"]:
        d["shuffle"] = (_bern(gen, b, aug["p_shuffle"] * scale),
                        torch.rand(b, l // int(0.5 * SR), generator=gen,
                                   device=gen.device))
    if aug["p_mixup"]:
        partner = torch.randint(0, pool, (b,), generator=gen,
                                device=gen.device)
        d["mixup"] = (partner, _bern(gen, b, aug["p_mixup"] * scale),
                      _u(gen, b, 0.4, 0.6), _u(gen, b))
    if aug["p_aug"]:
        p = aug["p_aug"] * scale
        if not (0.0 < p < 1.0 and b > 1):
            raise ValueError("the reference draws the chain's rows for "
                             "0 < p < 1 only")
        k = max(1, min(b, int(round(b * p))))
        rows = torch.randperm(b, generator=gen, device=gen.device)[:k]
        d["chain"] = (rows, _u(gen, b, 0.0, 50.0), _u(gen, b, 0.0, 50.0),
                      _u(gen, b, -300.0, 300.0), _u(gen, b, 2.0, 10.0),
                      _u(gen, b, 0.9, 1.1))
    return d


def shuffle_chunks(wave, lengths, apply, keys):
    """Permute each applied row's full 0.5 s chunks inside its valid
    region (rows with at least two), by the order of its keys."""
    b, l = wave.shape
    chunk = int(0.5 * SR)
    n_chunks = l // chunk
    if n_chunks < 2:
        return wave
    out = wave.clone()
    n_full = torch.clamp(lengths.long() // chunk, max=n_chunks).tolist()
    for r in range(b):
        n = n_full[r]
        if not bool(apply[r]) or n < 2:
            continue
        order = torch.argsort(keys[r, :n], stable=True)
        parts = wave[r, : n * chunk].view(n, chunk)[order]
        out[r, : n * chunk] = parts.reshape(-1)
    return out


def mixup(wave, lengths, labels, draws, partner):
    idx, apply, a, start = draws
    w2, l2, y2 = (t[idx] for t in partner)
    out, new_len, new_y = wave.clone(), lengths.clone(), labels.clone()
    for r in torch.nonzero(apply)[:, 0].tolist():
        n1, n2 = int(lengths[r]), int(l2[r])
        if n1 == n2:
            out[r] = (wave[r] + w2[r]) * 0.5
        else:
            longer, shorter = (wave[r], w2[r]) if n1 > n2 else (w2[r],
                                                               wave[r])
            n_long, n_short = max(n1, n2), min(n1, n2)
            s = int((start[r] * torch.tensor(float(max(n_long - n_short, 1)),
                                             device=start.device)).item())
            row = longer * a[r]
            row[s: s + n_short] = shorter[:n_short] * (1.0 - a[r])
            out[r] = row
        new_len[r] = max(n1, n2)
        new_y[r] = torch.clamp(labels[r] + y2[r], 0.0, 1.0)
    return out, new_len, new_y


# --------------------------------------------------------------------------
# the effects chain
# --------------------------------------------------------------------------


def reverb(wave, lengths, reverberance, room):
    """sox ``reverb reverberance 50 room`` (hf damping 50 %, pre-delay
    20 ms, wet gain 0 dB) as dry + wet, the wet path freeverb's transfer
    function applied by FFT over a power-of-two grid covering the clip and
    1.5 s; the valid length grows by the slowest comb's 60 dB decay."""
    b, l = wave.shape
    n = 1 << (l + int(1.5 * SR) - 1).bit_length()
    k = torch.arange(n // 2 + 1, device=wave.device, dtype=torch.float64)
    w = 2.0 * math.pi * k / n
    a_fb = -1.0 / math.log(1.0 - 0.3)
    b_fb = 100.0 / (math.log(1.0 - 0.98) * a_fb + 1.0)
    fb = (1.0 - torch.exp((reverberance.float() - b_fb) / (a_fb * b_fb)))
    scale = room.float() / 100.0 * 0.9 + 0.1
    sizes = torch.floor(scale[:, None] * torch.tensor(
        COMBS.astype(np.float32), device=wave.device) + 0.5).long()
    damp = 50.0 / 100.0 * 0.3 + 0.2
    z1 = torch.exp(-1j * w)
    h = torch.zeros(b, k.numel(), dtype=torch.complex128, device=wave.device)
    c = (fb.double() * (1.0 - damp))[:, None]
    for i in range(len(COMBS)):
        zn = torch.exp(-1j * 2.0 * math.pi
                       * ((k[None].long() * sizes[:, i:i + 1]) % n) / n)
        h = h + zn * (1.0 - damp * z1) / (1.0 - damp * z1 - c * zn)
    static = 0.015 * torch.ones_like(w, dtype=torch.complex128)
    for m in ALLPASSES:
        zm = torch.exp(-1j * w * float(m))
        static = static * (1.5 * zm - 1.0) / (1.0 - 0.5 * zm)
    static = static * torch.exp(-1j * w * float(int(0.02 * SR + 0.5)))
    y = torch.fft.irfft(torch.fft.rfft(wave.double(), n) * (h * static + 1.0),
                        n)[:, :l]
    level = float(np.log(np.float32(10.0 ** (-60.0 / 20.0))))
    tail = (level / (torch.log(fb) / sizes[:, -1].float())).to(torch.int32)
    new_len = torch.clamp(torch.clamp(lengths + tail, max=l), min=1)
    return y.float(), new_len.to(lengths.dtype)


def stretch(wave, lengths, rate, n_fft: int, hop: int):
    """Phase-vocoder time stretch by ``rate``: analysis frames (periodic
    Hann, centred, reflect padding), magnitudes interpolated at the output
    positions ``t * rate`` (clamped to the last frame), phases advanced by
    the deviation-corrected phase increments, inverse FFT frames windowed
    by Hann and overlap-added, normalized by the overlap-added squared
    window, the centre padding cropped; valid length ``int(length /
    rate)``."""
    b, l = wave.shape
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32,
                               device=wave.device)
    spec = torch.stft(wave.float(), n_fft, hop_length=hop, window=window,
                      center=True, pad_mode="reflect",
                      return_complex=True).transpose(1, 2)
    t_in, n_bins = spec.shape[1], spec.shape[2]
    mag, phase = spec.abs(), torch.angle(spec)
    expected = (2.0 * math.pi * torch.arange(
        n_bins, dtype=torch.float32, device=wave.device) / n_fft) * hop
    dev = phase[:, 1:] - phase[:, :-1] - expected
    dphi = dev - 2.0 * math.pi * torch.round(dev / (2.0 * math.pi)) + expected
    t_out = (l + n_fft // 2) // hop + 2
    rows = t_out + n_fft // hop - 1
    pos = torch.arange(rows, dtype=torch.float32,
                       device=wave.device)[None] * rate.float()[:, None]
    pm = torch.clamp(pos, 0.0, float(t_in - 1))
    i0 = torch.floor(pm).long()
    frac = (pm - torch.floor(pm))[..., None]
    i1 = torch.clamp(i0 + 1, max=t_in - 1)

    def pick(x, idx):
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))

    mags = (1.0 - frac) * pick(mag, i0) + frac * pick(mag, i1)
    steps = pick(dphi, torch.floor(torch.clamp(pos, 0.0, float(t_in - 2)))
                 .long()).double()
    phis = phase[:, :1].double() + torch.cumsum(steps, dim=1) - steps
    frames = torch.fft.irfft(torch.polar(mags.double(), phis), n_fft) \
        * window.double()
    out = torch.zeros(b, (rows + n_fft // hop - 1) * hop, dtype=torch.float64,
                      device=wave.device)
    wsum = torch.zeros(out.shape[1], dtype=torch.float64, device=wave.device)
    for t in range(rows):
        out[:, t * hop: t * hop + n_fft] += frames[:, t]
    for t in range(t_out):
        wsum[t * hop: t * hop + n_fft] += window.double() ** 2
    out = (out[:, : rows * hop]
           / torch.clamp(wsum[: rows * hop], min=1e-8))
    out = out[:, n_fft // 2: n_fft // 2 + l].float()
    if out.shape[1] < l:
        out = torch.nn.functional.pad(out, (0, l - out.shape[1]))
    new_len = torch.clamp(torch.clamp((lengths.float() / rate).to(
        torch.int32), max=l), min=1)
    valid = torch.arange(l, device=wave.device)[None] < new_len[:, None]
    return torch.where(valid, out, 0.0), new_len.to(lengths.dtype)


def overdrive(wave, gain_db, colour: float = 20.0):
    """sox ``overdrive gain 20``: soft clip of x 10^(gain/20) + colour/200,
    the DC blocker y[n] = d[n] - d[n-1] + 0.995 y[n-1] (float64), out =
    clip(x / 2 + 3/4 y, -1, 1)."""
    import scipy.signal

    d = wave * torch.pow(10.0, gain_db / 20.0)[:, None] + colour / 200.0
    d = torch.where(d < -1.0, -2.0 / 3.0,
                    torch.where(d > 1.0, 2.0 / 3.0, d - d ** 3 / 3.0))
    y = scipy.signal.lfilter([1.0, -1.0], [1.0, -0.995],
                             d.double().cpu().numpy(), axis=1)
    y = torch.from_numpy(y).to(wave.device).float()
    return torch.clamp(wave * 0.5 + y * 0.75, -1.0, 1.0)


def resample(wave, lengths, factor):
    """Linear interpolation at float32 positions ``i * factor``; positions
    at or past the valid length read 0; valid length ``int(length /
    factor)``."""
    b, l = wave.shape
    pos = torch.arange(l, dtype=torch.float32, device=wave.device)[None] \
        * factor.float()[:, None]
    i0 = torch.floor(pos).long()
    frac = pos - torch.floor(pos)
    padded = torch.cat([wave, wave.new_zeros(b, 1)], dim=1)
    taps = [torch.gather(padded, 1, torch.clamp(i, max=l))
            for i in (i0, i0 + 1)]
    out = torch.where(pos < lengths.float()[:, None],
                      (1.0 - frac) * taps[0] + frac * taps[1], 0.0)
    new_len = torch.clamp(torch.clamp((lengths.float() / factor.float()).to(
        torch.int32), max=l), min=1)
    return out, new_len.to(lengths.dtype)


def chain(wave, lengths, draws):
    rows, reverberance, room, cents, gain, speed = draws
    w, n = wave[rows], lengths[rows]
    w, n = reverb(w, n, reverberance[rows], room[rows])
    f = torch.exp2(cents[rows] / 1200.0)
    n_fft = min(1024, max(256, wave.shape[1] // 8))
    w, n = stretch(w, n, 1.0 / f, n_fft, n_fft // 4)
    w = overdrive(w, gain[rows])
    w, n = resample(w, n, speed[rows] * f)
    out, out_len = wave.clone(), lengths.clone()
    out[rows] = w
    out_len[rows] = n
    return out, out_len


def augment(wave, lengths, labels, gen, aug: dict, scale: float, partner):
    """One batch through the chain, ``partner`` the MixUp pool (wave,
    lengths, labels)."""
    b, l = wave.shape
    d = draw(gen, b, l, aug, scale, partner[0].shape[0])
    if "shuffle" in d:
        wave = shuffle_chunks(wave, lengths, *d["shuffle"])
    if "mixup" in d:
        wave, lengths, labels = mixup(wave, lengths, labels, d["mixup"],
                                      partner)
    if "chain" in d:
        wave, lengths = chain(wave, lengths, d["chain"])
    return wave, lengths, labels
