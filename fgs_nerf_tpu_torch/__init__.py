"""PyTorch/CUDA port of ``fgs_nerf_tpu`` (the JAX package stays the reference).

The package mirrors ``fgs_nerf_tpu/`` module for module.  Plain tensor
code is PyTorch; every Pallas TPU kernel on a ported path is a CUDA C++
kernel under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
and bound with ``ctypes`` (``ops/cuda/``).  A kernel wrapper launches its
kernel for CUDA tensors and runs its plain PyTorch twin for CPU tensors;
nothing else selects between the two.

It holds the three-stage training pipeline on both render engines
(``train/pipeline.py``, ``train/trainer.py``), checkpoints in the JAX
package's format, evaluation and meshing (``eval/``), every loader,
dp / sp parallelism (``parallel/``), the capture preprocessing
(``python -m fgs_nerf_tpu_torch.run_colmap``), the span recorder and
trace of ``utils/profiling.py`` (off unless turned on) and the command
line (``python -m fgs_nerf_tpu_torch.run``).
Importing the package imports neither ``jax`` nor any module of
``fgs_nerf_tpu``.
"""
