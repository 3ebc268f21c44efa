"""Analyses of SAE codes (own copies of ``sls_tpu/analysis``)."""
