"""Evaluation loops (counterpart of ``sls_tpu/evaluation``)."""
