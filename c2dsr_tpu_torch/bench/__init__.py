"""The port's bench: ``python -m c2dsr_tpu_torch.bench [--kernels |
--ce-variants | --scaled | --batches] [--device cpu]``.  The counterpart
of the JAX package's ``bench.py`` and ``bench/``, measured on the card;
every timing is gated on a correctness check that runs before it."""
