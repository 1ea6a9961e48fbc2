"""The plain reference that decides ``correct``: plain PyTorch, NumPy and
SciPy in float32 (float64 where noted), run with TF32 off.

It imports neither JAX nor the JAX package nor anything of the port, and
takes nothing that the port made: it reads the WAVs the benchmark wrote,
takes the weights the benchmark drew from the seed (``port_bench.weights``)
and works out the rest again: the bucket lengths, the log-mel features, the
augmentation from the same seeded draws, the model, the loss, the gradients
and Adam's update. ``model.Quant`` computes the model's convolutions and
matrix products through a narrower type: the control.
"""
