"""``python -m visiontransformer_tpu_torch serve [options]``: the REST
server with the GPU inference worker (serve/server.py)."""

import sys


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "serve":
        sys.exit("usage: python -m visiontransformer_tpu_torch serve "
                 "[--port N] [--device cuda|cpu] ...")
    from visiontransformer_tpu_torch.serve.server import main as serve_main

    serve_main(argv[1:])


if __name__ == "__main__":
    main()
