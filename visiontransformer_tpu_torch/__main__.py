"""``python -m visiontransformer_tpu_torch {train,serve} [options]``: the
training command and the REST server with the GPU inference worker
(cli.py)."""

import sys

from visiontransformer_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
