"""The benchmark of visiontransformer_tpu_torch on the H100 (run.py)."""
