from visiontransformer_tpu_torch.evaluation.compare import aggregate_metrics
from visiontransformer_tpu_torch.evaluation.evaluate import (
    CSV_HEADER,
    evaluate_model,
    run_sweep,
)

__all__ = ["CSV_HEADER", "aggregate_metrics", "evaluate_model", "run_sweep"]
