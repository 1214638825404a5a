"""SAM at a size the CPU runs in a second: width 32, 4 blocks of which block
2 is global, windows of 4 x 4 on a 6 x 6 grid (96^2 images), zero-padded to
8 x 8; a decoder 32 wide. The port knows it by ``SAM_TINY``'s name once
``SAM_TINY_GEOMETRY`` is among its presets (``models/sam.py``)."""

import copy

from benchmark import harness

SAM_TINY = "sam_test_tiny"
SAM_TINY_GEOMETRY = (32, 4, 2, (2,))
SAM_TINY_SIZE = 96


def sam_config():
    cfg = copy.deepcopy(harness.load_config("sam_vit_h_1024"))
    hf = cfg["hf_config"]
    hf["vision_config"].update(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
        global_attn_indexes=[2], window_size=4, image_size=SAM_TINY_SIZE,
        mlp_dim=64, output_channels=32, num_pos_feats=16)
    hf["prompt_encoder_config"].update(hidden_size=32,
                                       image_size=SAM_TINY_SIZE)
    hf["mask_decoder_config"].update(hidden_size=32, mlp_dim=64,
                                     num_attention_heads=2,
                                     iou_head_hidden_dim=32)
    cfg.update(image_size=SAM_TINY_SIZE, port_config_name=SAM_TINY)
    return cfg
