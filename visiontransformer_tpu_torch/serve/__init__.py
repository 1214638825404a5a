from visiontransformer_tpu_torch.serve.store import JobStore
from visiontransformer_tpu_torch.serve.server import create_server, ServingApp

__all__ = ["JobStore", "create_server", "ServingApp"]
