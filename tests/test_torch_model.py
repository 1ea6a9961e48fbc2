"""Parity of the port's 2d CNN with the JAX package's, on the CPU.

Weights are made with numpy from a seed in the JAX package's layout
(``interop.random_jax_variables``), run through the JAX model as they are and
through the port after ``interop.from_jax_variables``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from freesound_classification_tpu.models.classifiers import (
    TwoDimensionalCNN as JaxCNN,
)
from freesound_classification_tpu_torch import interop
from freesound_classification_tpu_torch.models.classifiers import (
    TwoDimensionalCNN,
    add_frequency_encoding,
)

N_CLASSES = 6


def _config(num_conv_blocks=2, start_deep_supervision_on=0,
            conv_base_depth=8, growth_rate=2.0):
    return dict(num_conv_blocks=num_conv_blocks,
                start_deep_supervision_on=start_deep_supervision_on,
                conv_base_depth=conv_base_depth, growth_rate=growth_rate)


def _port_model(cfg, params, stats, dtype=torch.float32):
    model = TwoDimensionalCNN(**cfg, aggregation_type="max",
                              n_classes=N_CLASSES, dtype=dtype)
    model.load_state_dict(interop.from_jax_variables(params, stats))
    return model.eval()


def _inputs(b, h, w, seed):
    rng = np.random.RandomState(seed)
    spec = rng.randn(b, h, w, 1).astype(np.float32)
    frame_lengths = rng.randint(1, w + 1, size=b).astype(np.int32)
    frame_lengths[0] = w
    return spec, frame_lengths


def _jax_logits(cfg, params, stats, spec, frame_lengths):
    model = JaxCNN(**cfg, aggregation_type="max", n_classes=N_CLASSES)
    out = model.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(spec), jnp.asarray(frame_lengths),
                      train=False)
    return np.asarray(out["class_logits"])


def test_random_variables_have_the_flax_layout():
    """The numpy weights name and shape every leaf as flax's init does."""
    cfg = _config(num_conv_blocks=3, start_deep_supervision_on=1,
                  growth_rate=1.5)
    spec, fl = _inputs(2, 32, 20, seed=0)
    model = JaxCNN(**cfg, aggregation_type="max", n_classes=N_CLASSES)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(spec),
                           jnp.asarray(fl), train=False)
    params, stats = interop.random_jax_variables(**cfg, n_classes=N_CLASSES,
                                                 seed=0)

    def shapes(tree):
        return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)),
                                      jax.tree_util.tree_map(np.asarray, tree))

    assert shapes(params) == shapes(variables["params"])
    assert shapes(stats) == shapes(variables["batch_stats"])


def test_state_dict_is_complete():
    cfg = _config()
    params, stats = interop.random_jax_variables(**cfg, n_classes=N_CLASSES,
                                                 seed=1)
    sd = interop.from_jax_variables(params, stats)
    model = TwoDimensionalCNN(**cfg, n_classes=N_CLASSES)
    assert set(sd) == set(model.state_dict())
    for key, value in model.state_dict().items():
        assert sd[key].shape == value.shape, key


@pytest.mark.parametrize("cfg,shape", [
    (_config(), (3, 32, 40)),
    (_config(num_conv_blocks=3, start_deep_supervision_on=1,
             growth_rate=1.5), (3, 32, 33)),
    # deeper than the time axis: the pools clamp to window 1 on size-1 axes
    (_config(num_conv_blocks=3, start_deep_supervision_on=2), (2, 8, 3)),
])
def test_logits_match_jax(cfg, shape):
    """(c) f32 eval logits with weights through interop. Tolerance 2e-4, the
    ROADMAP's init-forward tolerance: float32 convolutions summed in a
    different order by XLA and by PyTorch."""
    params, stats = interop.random_jax_variables(**cfg, n_classes=N_CLASSES,
                                                 seed=2)
    spec, fl = _inputs(*shape, seed=3)
    want = _jax_logits(cfg, params, stats, spec, fl)
    got = _port_model(cfg, params, stats)(torch.from_numpy(spec),
                                          torch.from_numpy(fl))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4,
                               rtol=2e-4)


def test_logits_do_not_depend_on_the_bucket():
    """(e) A clip padded into a longer bucket gives the same logits. The
    padded frames hold the log(1e-4) constant of a zero-padded waveform.
    Tolerance 1e-5: only the convolutions' widths differ.

    The buckets leave a few frames beyond the clip at every block: like the
    JAX model's, each block's input BatchNorm maps the masked zeros to a
    constant, which the convolutions' zero padding at the bucket's end is
    not, so a clip that ends within a receptive field of its bucket's end
    is not bucket-invariant in either package."""
    cfg = _config(num_conv_blocks=3, start_deep_supervision_on=1)
    params, stats = interop.random_jax_variables(**cfg, n_classes=N_CLASSES,
                                                 seed=4)
    model = _port_model(cfg, params, stats)
    rng = np.random.RandomState(5)
    valid = 45
    fl = torch.tensor([valid, 30], dtype=torch.int32)
    silence = float(np.log(1e-4))
    outs = []
    base = rng.randn(2, 32, valid).astype(np.float32)
    base[1, :, 30:] = silence
    for width in (64, 96, 177):
        spec = np.full((2, 32, width, 1), silence, np.float32)
        spec[:, :, :valid, 0] = base
        outs.append(model(torch.from_numpy(spec), fl).detach().numpy())
    for other in outs[1:]:
        np.testing.assert_allclose(other, outs[0], atol=1e-5, rtol=0)


def test_bf16_compute_stays_close_to_f32():
    """--bf16 runs the model in bfloat16 with float32 parameters; logits
    come out float32 and within bf16 rounding (~3 significant digits
    through a few layers: 5e-2) of the f32 model."""
    cfg = _config()
    params, stats = interop.random_jax_variables(**cfg, n_classes=N_CLASSES,
                                                 seed=6)
    spec, fl = _inputs(2, 32, 24, seed=7)
    args = (torch.from_numpy(spec), torch.from_numpy(fl))
    f32 = _port_model(cfg, params, stats)(*args).detach()
    bf16_model = _port_model(cfg, params, stats, dtype=torch.bfloat16)
    bf16 = bf16_model(*args).detach()
    assert bf16.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in bf16_model.parameters())
    np.testing.assert_allclose(bf16.numpy(), f32.numpy(), atol=5e-2,
                               rtol=5e-2)


def test_frequency_encoding_matches_jax():
    from freesound_classification_tpu.models.classifiers import (
        add_frequency_encoding as jax_add_frequency_encoding,
    )

    x = np.random.RandomState(8).randn(2, 17, 5, 1).astype(np.float32)
    np.testing.assert_allclose(
        add_frequency_encoding(torch.from_numpy(x)).numpy(),
        np.asarray(jax_add_frequency_encoding(jnp.asarray(x))), atol=1e-7)


def test_rnn_aggregation_not_ported_yet():
    """The rnn aggregation is ported now (``tests/test_torch_rnn.py`` holds
    it against JAX): a GRU pair after each supervised block, the head over
    their final states; an unknown aggregation still raises."""
    model = TwoDimensionalCNN(num_conv_blocks=3, start_deep_supervision_on=1,
                              conv_base_depth=8, aggregation_type="rnn")
    assert not hasattr(model, "rnn0")
    assert model.rnn2.GRUCell_1.weight_ih.shape == (3 * 128, 32)
    assert model.head.fc1.in_features == 2 * 2 * 128
    with pytest.raises(ValueError):
        TwoDimensionalCNN(aggregation_type="mean")
