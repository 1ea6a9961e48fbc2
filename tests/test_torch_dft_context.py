"""The port's fast featurization and the probe's two programs against
``scripts/probe_dft_context.py``, on the CPU: the cat-DFT basis, K9's plain
version against the probe's Pallas kernel in interpret mode, the wrapper,
``fast_featurize``, and V1 and V3 at a small width in both packages.

Inputs are made with numpy from seeds. The probe is loaded from its file
(``tests/_jax_scripts.py``), with JAX's cache settings put back after it.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from freesound_classification_tpu.models.classifiers import (
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu.models.frontend import Frontend as JaxFrontend
from freesound_classification_tpu.ops import dsp as jdsp
from freesound_classification_tpu_torch import bench
from freesound_classification_tpu_torch.ops import dsp, kernels
from freesound_classification_tpu_torch.ops import fast_featurize as ff
from freesound_classification_tpu_torch.probes import dft_context
from tests._jax_scripts import load_script

SR = 44100
FEATURES = "mel_2048_1024_128"
PAD = 1152  # the probe's lane-padded half width
# K9's plain version against the interpreted Pallas kernel: the same bf16
# magnitudes and exact bf16 x bf16 products, float32 (the port) against
# XLA's sums; a magnitude computed as one float32 chain and rounded once
# misses by ~1e-3 to 1e-2, so 1e-5 tells the two apart
K9_TOL = 1e-5
# fast_featurize against the probe's: each bf16 product is a float32 sum
# rounded once, in another order on each side, so a spectrum value may land
# one bf16 step (2^-8 relative) apart; a band's log-mel then moves by at
# most ~2 steps of its magnitude, log(1 + 2^-7) = 7.8e-3
FEATURIZE_TOL = 8e-3

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module")
def probe():
    return load_script("scripts/probe_dft_context.py")


@pytest.mark.parametrize("n_fft,hop", [(2048, 1024), (512, 256),
                                       (1024, 256)])
def test_dft_basis_is_the_jax_packages(n_fft, hop):
    for got, want in zip(ff.dft_basis(n_fft, hop),
                         jdsp._dft_basis(n_fft, hop)):
        np.testing.assert_array_equal(got, want)


def test_cat_basis_matches_the_probes(probe):
    """The probe's padded layout exactly, and the port's own: [cos | sin]
    side by side."""
    np.testing.assert_array_equal(ff.cat_basis(2048, 1024, PAD),
                                  probe._cat_basis())
    cos_b, sin_b = jdsp._dft_basis(2048, 1024)
    np.testing.assert_array_equal(ff.cat_basis(2048, 1024),
                                  np.concatenate([cos_b, sin_b], axis=-1))
    with pytest.raises(ValueError, match="im_offset"):
        ff.cat_basis(2048, 1024, 1024)


def _spectra(rows, seed):
    """bf16 [re | im] rows in the probe's padded layout (zero past 1025 in
    each half), levels spread over three decades."""
    rng = np.random.RandomState(seed)
    spec = rng.randn(rows, 2 * PAD) * 10.0 ** rng.uniform(-2, 1, (rows, 1))
    spec[:, 1025:PAD] = 0.0
    spec[:, PAD + 1025:] = 0.0
    return torch.from_numpy(spec.astype(np.float32)).bfloat16()


def _filterbank(kind, seed):
    """(1025, 128) bf16: the Slaney filterbank, or random non-negative."""
    if kind == "slaney":
        fb_t = dsp.mel_filterbank(SR, 2048, 128).T
    else:
        fb_t = np.random.RandomState(seed).rand(1025, 128) * 0.02
    return torch.from_numpy(np.ascontiguousarray(fb_t, np.float32)).bfloat16()


def _probe_kernel(probe, spec, fb_t):
    """The probe's Pallas kernel on one 256-row tile, interpreted."""
    fb_p = jnp.pad(jnp.asarray(fb_t.float().numpy()).astype(jnp.bfloat16),
                   ((0, PAD - fb_t.shape[0]), (0, 0)))
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            probe._mel_log_split_kernel, grid=(1,),
            in_specs=[pl.BlockSpec((256, 2 * PAD), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec((PAD, 128), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((256, 128), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((256, 128), jnp.float32),
        )(jnp.asarray(spec.float().numpy()).astype(jnp.bfloat16), fb_p)
    return np.asarray(out)


@pytest.mark.parametrize("fb_kind", ["random", "slaney"])
def test_k9_plain_matches_the_probe_kernel(probe, fb_kind):
    """(256, 2 x 1152) bf16 spectra in the probe's layout through the
    wrapper (CPU: the plain version) with im_offset 1152: within 1e-5 of
    the interpreted kernel, written (B, M, T)."""
    spec, fb_t = _spectra(256, seed=1), _filterbank(fb_kind, seed=2)
    want = _probe_kernel(probe, spec, fb_t)
    before = kernels.mel_log_split.launches
    got = kernels.mel_log_split(spec[None], fb_t, 1025, PAD)
    assert kernels.mel_log_split.launches == before
    assert got.shape == (1, 128, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].T.numpy(), want, atol=K9_TOL, rtol=0)


@pytest.mark.parametrize("fb_kind", ["random", "slaney"])
def test_k9_float32_chain_magnitude_misses_the_probe_kernel(probe, fb_kind):
    """The magnitude as one float32 chain rounded to bf16 once is another
    function: it misses the interpreted kernel by far more than K9_TOL, so
    the comparison above pins the per-operation rounding."""
    spec, fb_t = _spectra(256, seed=3), _filterbank(fb_kind, seed=4)
    want = _probe_kernel(probe, spec, fb_t)
    re, im = spec[:, :1025].float(), spec[:, PAD:PAD + 1025].float()
    mag = torch.sqrt(re * re + im * im).bfloat16().float()
    chain = torch.log(mag @ fb_t.float() + kernels.LOG_EPS).numpy()
    assert np.abs(chain - want).max() > 10 * K9_TOL
    per_op = kernels.split_magnitude(spec, 1025, PAD)
    assert (per_op.float() != mag).float().mean() > 0.01


def test_k9_wrapper_checks_and_raises_off_cpu():
    spec = _spectra(8, seed=5)[None]
    fb_t = _filterbank("slaney", seed=0)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.mel_log_split(spec.to("meta"), fb_t, 1025, PAD)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.mel_log_split(spec, fb_t.to("meta"), 1025, PAD)
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.mel_log_split(spec.float(), fb_t, 1025, PAD)
    with pytest.raises(ValueError, match="do not fit"):
        kernels.mel_log_split(spec, fb_t, 1025, 1024)  # halves overlap
    with pytest.raises(ValueError, match="do not fit"):
        kernels.mel_log_split(spec, fb_t, 1025, PAD + 128)  # past the row
    with pytest.raises(ValueError, match="F=1025"):
        kernels.mel_log_split(spec, fb_t[:1024], 1025, PAD)


def _clips(b, seconds, seed):
    """(B, L) clips of ragged valid lengths (zero past them) from 1 s up."""
    rng = np.random.RandomState(seed)
    length = int(seconds * SR)
    lengths = np.linspace(length, SR, b).astype(np.int32)
    wave = (0.1 * rng.randn(b, length)).astype(np.float32)
    wave[np.arange(length)[None] >= lengths[:, None]] = 0.0
    return wave, lengths


def _probe_inputs(probe, wave, lengths):
    """The probe's ``fast_inputs``: log-mel (B, M, T) and frame lengths."""
    fb = dsp.mel_filterbank(SR, 2048, 128)
    with pltpu.force_tpu_interpret_mode():
        spec = np.asarray(probe.fast_featurize(jnp.asarray(wave),
                                               jnp.asarray(fb.T)))
    frames = np.minimum(lengths // 1024 + 1, spec.shape[-1])
    return spec, frames


@pytest.mark.parametrize("b,seconds", [(1, 1.3), (3, 2.7)])
def test_fast_featurize_matches_the_probe(probe, b, seconds):
    """B = 1 and 3, ragged clips of 1-3 s: 56 and 3 x 117 rows of frames
    (not multiples of the probe's 256-row tile). Frame lengths exactly,
    log-mel within FEATURIZE_TOL; the probe's padded layout through the
    port gives the same log-mel."""
    wave, lengths = _clips(b, seconds, seed=b)
    want, want_frames = _probe_inputs(probe, wave, lengths)
    front = ff.FastFrontend(FEATURES, sr=SR, device="cpu")
    got, frames = front(torch.from_numpy(wave), torch.from_numpy(lengths))
    assert got.shape == want.shape + (1,)
    np.testing.assert_array_equal(frames.numpy(), want_frames)
    np.testing.assert_allclose(got[..., 0].numpy(), want,
                               atol=FEATURIZE_TOL, rtol=0)
    padded = ff.fast_featurize(
        torch.from_numpy(wave), front.fb_t,
        torch.from_numpy(ff.cat_basis(2048, 1024, PAD)).bfloat16())
    np.testing.assert_allclose(padded.numpy(), want, atol=FEATURIZE_TOL,
                               rtol=0)


NET = dict(num_conv_blocks=2, start_deep_supervision_on=0, conv_base_depth=8,
           growth_rate=1.5, aggregation_type="max")
N_FOLDS = 2


def _jax_ensemble(variables, frontend_fn):
    """The probe's ``model_5fold`` over folds stacked from the port's
    variables, float32."""
    model = JaxCNN(**NET, n_classes=bench.N_CLASSES, fused_infer=False)
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[{"params": p, "batch_stats": s} for p, s in variables])

    def run(wave, lengths):
        x, f = frontend_fn(wave, lengths)
        logits = jax.vmap(lambda v: model.apply(v, x, f, train=False)[
            "class_logits"])(stacked)
        return np.asarray(jnp.mean(jax.nn.sigmoid(logits), axis=0))

    return run


def test_v1_and_v3_match_the_probes_programs(probe):
    """V1 and V3 at a small width (2 blocks, depth 8, 2 folds, float32, 80
    classes), the same fold weights in both packages through ``interop``:
    V1 within 1e-4 (featurizations ~1e-6 relative apart: FFT against the
    block-DFT, whose "default" precision XLA computes in float32 on the
    CPU), V3 within 1e-4 too: where a bf16 spectrum value lands one step
    apart (FEATURIZE_TOL on a band's log-mel) the float32 model's
    probabilities move by ~1e-6 (3e-7 measured), while V3 differs from V1
    (the bf16 single-pass DFT) by several 1e-4, so the tolerance tells the
    two programs apart."""
    variables = bench.random_fold_variables(N_FOLDS, NET, seed=3)
    preds = dft_context.predictors(
        bench.fold_models(variables, NET, dtype=torch.float32), "cpu")
    wave, lengths = _clips(3, 2.0, seed=7)
    jax_front = JaxFrontend(FEATURES, "2d", sr=SR, use_pallas=True,
                            dft_precision="default")

    def fast_inputs(w, ln):
        spec, frames = _probe_inputs(probe, np.asarray(w), np.asarray(ln))
        return jnp.asarray(spec)[..., None], jnp.asarray(frames, jnp.int32)

    want = {"V1": _jax_ensemble(variables, jax_front)(
                jnp.asarray(wave), jnp.asarray(lengths)),
            "V3": _jax_ensemble(variables, fast_inputs)(wave, lengths)}
    got = {name: p.predict_batch(torch.from_numpy(wave),
                                 torch.from_numpy(lengths)).numpy()
           for name, p in preds.items()}
    assert got["V1"].shape == (3, bench.N_CLASSES)
    np.testing.assert_allclose(got["V1"], want["V1"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["V3"], want["V3"], atol=1e-4, rtol=0)
    assert np.abs(got["V3"] - got["V1"]).max() > 2e-4
    diff, corr = dft_context.compare(torch.from_numpy(got["V1"]),
                                     torch.from_numpy(got["V3"]))
    assert diff == pytest.approx(np.abs(got["V1"] - got["V3"]).max())
    assert 0.99 < corr <= 1.0


def test_probe_main_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would run the probe")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dft_context.main()
