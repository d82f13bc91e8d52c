"""Host-only data tools, the counterparts of the JAX package's ``tools/``
data tools: ``python -m c2dsr_tpu_torch.tools.dataset_stats RAW_DIR`` and
``python -m c2dsr_tpu_torch.tools.leak_stats RAW_DIR``."""
