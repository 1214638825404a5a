from visiontransformer_tpu_torch.data.classdict import (
    assign_closest_class,
    convert_bw,
    load_classdict,
)
from visiontransformer_tpu_torch.data.split import train_val_test_split
from visiontransformer_tpu_torch.data.dataset import CESegmentationDataset, PAEDBinaryDataset

__all__ = [
    "assign_closest_class",
    "convert_bw",
    "load_classdict",
    "train_val_test_split",
    "CESegmentationDataset",
    "PAEDBinaryDataset",
]
