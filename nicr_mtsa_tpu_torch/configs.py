"""Model presets of the port (counterpart of nicr_mtsa_tpu/configs.py;
the same field values, with the compute dtype named as a string).
`BENCH_CONFIGS` holds the six `bench.py --model` presets under the
JAX package's names."""
import dataclasses
from typing import Tuple

from .models.multi_task import MultiTaskModelConfig


def resnet18_rgb_semantic(n_classes: int = 40,
                          input_size: Tuple[int, int] = (480, 640),
                          dtype: str = 'float32') -> MultiTaskModelConfig:
    """ResNet-18 (basic blocks) on RGB alone, semantic segmentation:
    a single-backbone encoder, PPM context, dense decoder."""
    return MultiTaskModelConfig(
        tasks=('semantic',),
        backbone_rgb='resnet18', backbone_depth=None,
        resnet_block='basicblock',
        context_module='ppm', context_n_channels=512,
        decoder_n_channels=(512, 256, 128), decoder_n_blocks=3,
        input_size=tuple(input_size), semantic_n_classes=n_classes,
        dtype=dtype)


def rgbd_resnet34_nbt1d_semantic(
        n_classes: int = 37, input_size: Tuple[int, int] = (480, 640),
        dtype: str = 'bfloat16') -> MultiTaskModelConfig:
    """RGB-D 2x ResNet-34 NBt1D with SE-add fusion + the semantic
    decoder (SUNRGB-D's 37 classes, ESANet-style)."""
    return MultiTaskModelConfig(
        tasks=('semantic',),
        backbone_rgb='resnet34', backbone_depth='resnet34',
        resnet_block='nonbottleneck1d', encoder_fusion='se-add-uni-rgb',
        context_module='ppm', context_n_channels=512,
        decoder_n_channels=(512, 256, 128), decoder_n_blocks=3,
        input_size=tuple(input_size), semantic_n_classes=n_classes,
        dtype=dtype)


def panoptic_resnet34_nbt1d(
        n_classes: int = 40, input_size: Tuple[int, int] = (480, 640),
        dtype: str = 'bfloat16') -> MultiTaskModelConfig:
    """Panoptic: the semantic decoder and the instance centre / offset
    decoder (no orientation) on the RGB-D 2x ResNet-34 NBt1D encoder
    (NYUv2)."""
    return dataclasses.replace(
        rgbd_resnet34_nbt1d_semantic(n_classes, input_size, dtype),
        tasks=('semantic', 'instance'),
        upsampling='learned-3x3-zeropad',
        prediction_upsampling='learned-3x3-zeropad')


def emsanet(n_classes: int = 40, scene_n_classes: int = 10,
            input_size: Tuple[int, int] = (480, 640),
            dtype: str = 'bfloat16') -> MultiTaskModelConfig:
    """EMSANet: panoptic with instance orientation and scene
    classification on the RGB-D 2x ResNet-34 NBt1D encoder."""
    return dataclasses.replace(
        panoptic_resnet34_nbt1d(n_classes, input_size, dtype),
        tasks=('semantic', 'instance', 'orientation', 'scene'),
        scene_n_classes=scene_n_classes)


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


BENCH_CONFIGS = {
    'resnet18_rgb_semantic': resnet18_rgb_semantic,
    'rgbd_resnet34_nbt1d_semantic': rgbd_resnet34_nbt1d_semantic,
    'panoptic_resnet34_nbt1d': panoptic_resnet34_nbt1d,
    'emsanet': emsanet,
    'emsaformer_dve': emsaformer_dve,
    'emsaformer_dve_v2': emsaformer_dve_v2,
}
