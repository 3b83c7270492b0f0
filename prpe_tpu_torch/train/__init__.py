"""The round-robin multi-task training path (``prpe_tpu/train/``)."""
