"""c2dsr_tpu_torch — the PyTorch + CUDA port of c2dsr_tpu for one NVIDIA H100.

The JAX package ``c2dsr_tpu`` is the reference; this package imports
neither it nor JAX, and keeps its own copies of the numpy-only layers
(config, data, graph, metrics).  Every Pallas kernel of the JAX package that
the ported path runs is a hand-written CUDA kernel here (``csrc/``, built by
``kernels/build.py``), with a plain PyTorch version beside it that CPU
tensors take.  Ported so far: the ranking (serving) path, ``evaluate/``;
the training step, ``train/step.py`` (forward, backward and the optimizer
step, with the batch-sparse propagation of ``batch_sparse_gnn``); and the
experiment entry point: ``train/loop.Experiment``, ``cli.py``
(``python -m c2dsr_tpu_torch.cli``), ``checkpoint.py`` and ``noter.py``.
"""

__version__ = "0.1.0"

from c2dsr_tpu_torch.config import Config, DataSpec  # noqa: F401
