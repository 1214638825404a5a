"""Command-line tools of the port that are not part of the serving or
training path: the flash-attention tuning sweeps (``tune_flash2``,
``tune_flash3``), run as ``python -m visiontransformer_tpu_torch.scripts.<name>``."""
