"""The benchmark of euispice_coreg_tpu_torch on one CUDA card (README.md)."""
