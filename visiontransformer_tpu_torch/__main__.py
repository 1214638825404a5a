"""``python -m visiontransformer_tpu_torch {train,serve,convert,export,
export-serving,register-model} [options]``: the training command, the REST
server with the GPU inference worker, the checkpoint converters, the
serving-program export and the model registration (cli.py)."""

import sys

from visiontransformer_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
