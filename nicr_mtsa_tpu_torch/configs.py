"""Model presets of the port (counterpart of nicr_mtsa_tpu/configs.py;
the same field values, with the compute dtype named as a string)."""
import dataclasses
from typing import Tuple

from .models.multi_task import MultiTaskModelConfig


def emsaformer_dve(n_classes: int = 40, scene_n_classes: int = 10,
                   embedding_dim: int = 512,
                   input_size: Tuple[int, int] = (480, 640),
                   dtype: str = 'bfloat16') -> MultiTaskModelConfig:
    """EMSAFormer: multimodal Swin-T-128 RGB-D (v1, 7x7 windows) + MLP
    decoders + the dense-visual-embedding head."""
    return MultiTaskModelConfig(
        tasks=('semantic', 'instance', 'orientation', 'scene',
               'dense_visual_embedding'),
        backbone_rgb=None, backbone_depth=None,
        backbone_rgbd='swin-multi-t-128',
        context_module='ppm', context_n_channels=512,
        decoder_type='mlp', decoder_n_channels=(256, 128, 128, 128),
        encoder_decoder_fusion='swin-ln-select',
        upsampling='bilinear', prediction_upsampling='bilinear',
        input_size=tuple(input_size), semantic_n_classes=n_classes,
        scene_n_classes=scene_n_classes, embedding_dim=embedding_dim,
        dtype=dtype)


def emsaformer_dve_v2(n_classes: int = 40, scene_n_classes: int = 10,
                      embedding_dim: int = 512,
                      input_size: Tuple[int, int] = (480, 640),
                      dtype: str = 'bfloat16') -> MultiTaskModelConfig:
    """EMSAFormer on the SwinV2-T-128 multimodal backbone (8x8 windows,
    cosine attention, log-CPB)."""
    return dataclasses.replace(
        emsaformer_dve(n_classes, scene_n_classes, embedding_dim,
                       input_size, dtype),
        backbone_rgbd='swin-multi-t-v2-128')


CONFIGS = {'emsaformer_dve': emsaformer_dve,
           'emsaformer_dve_v2': emsaformer_dve_v2}
