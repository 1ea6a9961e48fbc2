"""APC, autoregressive predictive coding (JAX ``models/apc.py``).

LayerNorm without scale or bias over the per-frame features (B, T, F) ->
a stack of forward LSTMs (flax ``OptimizedLSTMCell``s, one ``torch._VF.
lstm`` call: cuDNN on the card) -> the output LayerNorm -> per-step linear
heads that regress the normalized input ``step`` frames ahead, with an L1
loss over the frames whose target is valid. The LSTMs are causal, so the
outputs at valid frames do not depend on the padding after them.
"""

from __future__ import annotations

import torch
from torch import nn

from freesound_classification_tpu_torch.models.blocks import (
    LayerNorm,
    Linear,
    LSTMCell,
    lstm_sequence,
    time_mask,
)


class APCModel(nn.Module):
    """``forward(feats (B, T, F), frame_lengths (B,))`` -> {"loss_parts":
    per prediction step its (masked error sum, valid positions), float32,
    which ``blocks.loss_terms`` divides into JAX's ``loss_terms``,
    "output": (B, T, rnn_size) float32, "predictions": per step (B,
    T - step, F)}. Module names follow flax's (``OptimizedLSTMCell_{l}``,
    ``output_norm``, ``prediction_{s}``), so ``interop`` maps them by
    name."""

    def __init__(self, input_dim: int, rnn_size: int = 256,
                 rnn_layers: int = 3, prediction_steps: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.rnn_layers = rnn_layers
        self.prediction_steps = prediction_steps
        self.input_norm = LayerNorm(input_dim, affine=False)
        for layer in range(rnn_layers):
            setattr(self, f"OptimizedLSTMCell_{layer}",
                    LSTMCell(input_dim if layer == 0 else rnn_size,
                             rnn_size))
        self.output_norm = LayerNorm(rnn_size)
        for step in range(1, prediction_steps + 1):
            setattr(self, f"prediction_{step}", Linear(rnn_size, input_dim))

    def forward(self, feats: torch.Tensor,
                frame_lengths: torch.Tensor) -> dict:
        x = self.input_norm(feats.to(self.dtype))
        cells = [getattr(self, f"OptimizedLSTMCell_{layer}")
                 for layer in range(self.rnn_layers)]
        output = self.output_norm(lstm_sequence(x, cells))
        mask = time_mask(frame_lengths, feats.shape[1]).to(torch.float32)
        target = x.detach()
        loss_parts, predictions = [], []
        for step in range(1, self.prediction_steps + 1):
            pred = getattr(self, f"prediction_{step}")(output[:, :-step])
            predictions.append(pred)
            err = (target[:, step:] - pred).abs().sum(dim=-1).float()
            # position t counts where frame t + step is valid
            m = mask[:, step:]
            loss_parts.append(((err * m).sum(), m.sum()))
        return {"loss_parts": loss_parts, "output": output.float(),
                "predictions": predictions}
