from visiontransformer_tpu_torch.ckpt.torch_convert import (
    convert_hf_vit_state,
    convert_vitseg_state,
    load_lightning_checkpoint,
)

__all__ = [
    "convert_hf_vit_state",
    "convert_vitseg_state",
    "load_lightning_checkpoint",
]
