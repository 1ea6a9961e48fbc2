"""The port's constructors run on the card unless the caller passes
device="cpu": without a usable card, the default raises rather than quietly
building on the CPU.

Each test hides any card (``torch.cuda.is_available`` returns False), so it
checks the same rule on a machine with one.
"""

import types

import pytest
import torch

from freesound_classification_tpu_torch.models.frontend import Frontend
from freesound_classification_tpu_torch.ops.fast_featurize import FastFrontend
from freesound_classification_tpu_torch.training.engine import Engine

DESCRIPTOR = "mel_512_256_32"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_frontend_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Frontend(DESCRIPTOR, "2d", sr=8000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Frontend("stft_256_128", "1d", sr=8000)  # no tensor of its own
    front = Frontend(DESCRIPTOR, "2d", sr=8000, device="cpu")
    assert front.device == torch.device("cpu")
    assert front.filterbank.device == torch.device("cpu")


def test_fast_frontend_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FastFrontend(DESCRIPTOR, sr=8000)
    front = FastFrontend(DESCRIPTOR, sr=8000, device="cpu")
    assert front.basis.device == front.fb_t.device == torch.device("cpu")


def test_engine_defaults_to_the_card(no_card):
    config = types.SimpleNamespace()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(torch.nn.Linear(2, 2), None, config)
    engine = Engine(torch.nn.Linear(2, 2), None, config, device="cpu")
    assert engine.device == torch.device("cpu")
    assert next(engine.model.parameters()).device == torch.device("cpu")
