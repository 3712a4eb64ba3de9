"""The benchmark of ``clair3_tpu_torch``; ``run.py`` runs one cell once."""
