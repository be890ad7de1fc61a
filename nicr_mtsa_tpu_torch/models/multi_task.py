"""Multi-task model composition: fused RGB-D encoder -> context module
-> one dense decoder per enabled task (counterpart of
nicr_mtsa_tpu/models/multi_task.py `MultiTaskModelConfig` and
`build_model`, dense family).

The config names its compute dtype as a string ('float32' or
'bfloat16'); parameters are float32 and the modules compute in the
dtype of their inputs, which the serving pipeline sets from the
config. `build_model` initialises from a seeded `torch.Generator` on
the CPU, so a seed gives the same weights on every device, then moves
the model to its device (`cuda` unless the caller asks otherwise)."""
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..utils.device import resolve_device
from .backbones import get_resnet_backbone
from .context import get_context_module
from .decoders import (InstanceDecoder, SceneClassificationDecoder,
                       SemanticDecoder)
from .encoder import FusedRGBDEncoder

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclass
class MultiTaskModelConfig:
    """EMSANet-style configuration; defaults follow the JAX package's
    (2x ResNet-34 NBt1D, se-add fusion, PPM context, dense decoders
    with NBt1D blocks at (512, 256, 128) channels)."""
    tasks: Tuple[str, ...] = ('semantic', 'instance', 'orientation',
                              'scene')
    backbone_rgb: str = 'resnet34'
    backbone_depth: str = 'resnet34'
    resnet_block: str = 'nonbottleneck1d'
    encoder_fusion: str = 'se-add-uni-rgb'
    normalization: str = 'batchnorm'
    activation: str = 'relu'
    skip_downsamplings: Tuple[int, ...] = (4, 8, 16)
    context_module: str = 'ppm'
    context_n_channels: int = 512
    input_size: Tuple[int, int] = (480, 640)
    decoder_n_channels: Tuple[int, ...] = (512, 256, 128)
    decoder_downsamplings: Tuple[int, ...] = (16, 8, 4)
    decoder_block: str = 'nonbottleneck1d'
    decoder_n_blocks: int = 3
    encoder_decoder_fusion: str = 'add-rgb'
    upsampling: str = 'learned-3x3-zeropad'
    prediction_upsampling: str = 'learned-3x3-zeropad'
    semantic_n_classes: int = 40
    scene_n_classes: int = 10
    # False, or 'all': both semantic prediction upsamplings returned as
    # a DeferredUpsampling2 for the fused 4x finisher
    defer_semantic_prediction_upsampling: object = False
    dtype: str = 'float32'

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


class MultiTaskModel(nn.Module):
    """Composed network; `forward({'rgb', 'depth'})` returns
    {task: (main, side_outputs)} with NCHW tensors."""

    def __init__(self, encoder, context_module,
                 semantic_decoder: Optional[nn.Module] = None,
                 instance_decoder: Optional[nn.Module] = None,
                 scene_decoder: Optional[nn.Module] = None):
        super().__init__()
        self.encoder = encoder
        self.context_module = context_module
        self.semantic_decoder = semantic_decoder
        self.instance_decoder = instance_decoder
        self.scene_decoder = scene_decoder

    def forward(self, inputs: dict) -> dict:
        enc_out, skips = self.encoder(inputs)
        x = self.context_module(enc_out['rgb'])
        outputs = {}
        for task, dec in (('semantic', self.semantic_decoder),
                          ('instance', self.instance_decoder),
                          ('scene', self.scene_decoder)):
            if dec is not None:
                outputs[task] = dec(x, skips)
        return outputs


def build_model(config: MultiTaskModelConfig, device=None,
                seed: int = 0) -> MultiTaskModel:
    """Build the dense-family model, randomly initialised from `seed`,
    in eval mode on `device` (default `cuda`)."""
    device = resolve_device(device)
    c = config
    g = torch.Generator().manual_seed(seed)
    bb = {m: get_resnet_backbone(name, block=c.resnet_block,
                                 n_input_channels=n_in,
                                 normalization=c.normalization,
                                 activation=c.activation, generator=g)
          for m, name, n_in in (('rgb', c.backbone_rgb, 3),
                                ('depth', c.backbone_depth, 1))}
    encoder = FusedRGBDEncoder(
        bb['rgb'], bb['depth'], fusion=c.encoder_fusion,
        act=c.activation, skip_downsamplings=c.skip_downsamplings,
        generator=g)
    context = get_context_module(
        c.context_module, encoder.n_channels_out, c.context_n_channels,
        normalization=c.normalization, activation=c.activation,
        generator=g)

    ds_to_channels = dict(zip(encoder.skips_downsamplings,
                              encoder.skips_n_channels))
    fusion_downsamplings = tuple(sorted(encoder.skips_downsamplings,
                                        reverse=True))
    common = dict(
        n_channels_in=c.context_n_channels,
        downsampling_in=encoder.downsampling,
        n_channels=c.decoder_n_channels,
        downsamplings=c.decoder_downsamplings,
        block=c.decoder_block, n_blocks=c.decoder_n_blocks,
        fusion=c.encoder_decoder_fusion,
        fusion_n_channels=tuple(ds_to_channels[ds]
                                for ds in fusion_downsamplings),
        fusion_downsamplings=fusion_downsamplings,
        norm=c.normalization, act=c.activation,
        upsampling=c.upsampling,
        prediction_upsampling=c.prediction_upsampling,
    )
    tasks = set(c.tasks)
    semantic = instance = scene = None
    if tasks & {'semantic', 'panoptic'}:
        semantic = SemanticDecoder(
            n_classes=c.semantic_n_classes,
            defer_prediction_upsampling=(
                c.defer_semantic_prediction_upsampling),
            generator=g, **common)
    if tasks & {'instance', 'panoptic'}:
        instance = InstanceDecoder(
            with_orientation='orientation' in tasks, generator=g,
            **common)
    if 'scene' in tasks:
        # the PPM's global branch has n_channels_in // len(bins) channels
        scene = SceneClassificationDecoder(
            encoder.n_channels_out // len(context.bins),
            c.scene_n_classes, generator=g)
    model = MultiTaskModel(encoder, context, semantic, instance, scene)
    return model.eval().to(device)
