"""PyTorch/CUDA port of freesound_classification_tpu.

The JAX package beside this one is the reference: every module here mirrors
its counterpart's name and public layout, and the tests under
``tests/test_torch_*.py`` hold the two against each other on the CPU. This
package imports torch and numpy, never jax. The hand-written CUDA kernels live
in ``csrc/`` and are built at first use (``ops/build.py``).
"""
