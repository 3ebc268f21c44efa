"""Detection metrics (own copies of ``sls_tpu/metrics``)."""
