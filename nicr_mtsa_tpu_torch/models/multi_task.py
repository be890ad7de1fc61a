"""Multi-task model composition: encoder -> context module -> one
decoder per enabled task (counterpart of nicr_mtsa_tpu/models/
multi_task.py `MultiTaskModelConfig` and `build_model`): the dense
family (fused dual-backbone RGB-D encoder, or a single rgb or depth
backbone; dense decoders) and the MLP
family (a single 4-channel rgbd backbone such as the multimodal Swin,
SegFormer-style MLP decoders); each names its tasks from the JAX
package's registry (`KNOWN_TASKS`: the semantic, instance (with the
orientation head), normal, scene and dense-visual-embedding decoders,
'panoptic' for the semantic and instance decoders), and a name it
does not build raises.

The config names its compute dtype as a string ('float32',
'bfloat16', or 'float64' for a reference run on the CPU, with the
model's parameters in float64 too); parameters are float32 and the modules compute in the
dtype of their inputs, which the serving pipeline sets from the
config. `build_model` initialises from a seeded `torch.Generator` on
the CPU, so a seed gives the same weights on every device, then moves
the model to its device (`cuda` unless the caller asks otherwise)."""
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..utils.device import resolve_device
from .backbones import get_backbone
from .context import get_context_module
from .decoders import (EmbeddingDecoder, EmbeddingMLPDecoder,
                       InstanceDecoder, InstanceMLPDecoder, NormalDecoder,
                       NormalMLPDecoder, SceneClassificationDecoder,
                       SemanticDecoder, SemanticMLPDecoder)
from .encoder import Encoder, FusedRGBDEncoder

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
          'float64': torch.float64}
# the JAX package's task registry (nicr_mtsa_tpu/multi_task.py), in its
# order: 'orientation' is the instance decoder's third head, 'panoptic'
# the semantic and instance decoders together
KNOWN_TASKS = ('semantic', 'instance', 'orientation', 'normal', 'scene',
               'panoptic', 'dense_visual_embedding')


@dataclass
class MultiTaskModelConfig:
    """EMSANet-style configuration; defaults follow the JAX package's
    (2x ResNet-34 NBt1D, se-add fusion, PPM context, dense decoders
    with NBt1D blocks at (512, 256, 128) channels)."""
    tasks: Tuple[str, ...] = ('semantic', 'instance', 'orientation',
                              'scene')
    backbone_rgb: Optional[str] = 'resnet34'
    backbone_depth: Optional[str] = 'resnet34'
    # a single 4-channel rgbd backbone instead of rgb + depth
    backbone_rgbd: Optional[str] = None
    resnet_block: str = 'nonbottleneck1d'
    encoder_fusion: str = 'se-add-uni-rgb'
    normalization: str = 'batchnorm'
    activation: str = 'relu'
    skip_downsamplings: Tuple[int, ...] = (4, 8, 16)
    context_module: str = 'ppm'
    context_n_channels: int = 512
    input_size: Tuple[int, int] = (480, 640)
    decoder_type: str = 'dense'             # 'dense' | 'mlp'
    decoder_n_channels: Tuple[int, ...] = (512, 256, 128)
    decoder_downsamplings: Tuple[int, ...] = (16, 8, 4)
    decoder_block: str = 'nonbottleneck1d'
    decoder_n_blocks: int = 3
    encoder_decoder_fusion: str = 'add-rgb'
    upsampling: str = 'learned-3x3-zeropad'
    prediction_upsampling: str = 'learned-3x3-zeropad'
    semantic_n_classes: int = 40
    scene_n_classes: int = 10
    embedding_dim: int = 512
    # the random parts of training: the Swin backbone's stochastic depth
    # (its last block's rate; None: the variant's, 0.2 for Swin-T) and
    # the MLP decoders' channel dropout (the JAX modules' defaults)
    stochastic_depth: Optional[float] = None
    decoder_dropout: float = 0.1
    # False; True: the last semantic prediction upsampling (learned)
    # returned as a DeferredUpsampling for the fused 2x finisher; or
    # 'all': both returned as a DeferredUpsampling2 (learned) or
    # DeferredBilinear2 (bilinear) for the fused 4x finisher
    defer_semantic_prediction_upsampling: object = False
    # window-attention backend of Swin blocks at inference: 'auto' (the
    # whole-sub-block kernel; training always takes the differentiable
    # core) or 'qkv' (the qkv product in torch, then attention over the
    # packed qkv; inference only), see backbones.ATTN_BACKENDS
    backbone_attn_backend: str = 'auto'
    # activation recompute in training (models/remat.py; `bench.py
    # --remat`): backbone_remat recomputes the encoder blocks of both
    # families (ResNet/NBt1D residual blocks, Swin blocks),
    # decoder_remat the dense decoders' residual blocks; the parameters
    # are unchanged and weights interchange
    backbone_remat: bool = False
    decoder_remat: bool = False
    # images per window-attention chunk in Swin blocks (0: the whole
    # batch; `bench.py --attn-chunk`)
    backbone_attn_chunk_size: int = 0
    dtype: str = 'float32'

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


class MultiTaskModel(nn.Module):
    """Composed network; `forward({'rgb', 'depth'})` (or `{'rgbd'}`, or
    the one modality of a single rgb or depth backbone)
    returns {task: (main, side_outputs)} with NCHW tensors. Training
    mode is `train()`: every module that runs then trains (BatchNorm
    statistics, dropout, stochastic depth), and the dense decoders give
    their side outputs."""

    def __init__(self, encoder, context_module,
                 semantic_decoder: Optional[nn.Module] = None,
                 instance_decoder: Optional[nn.Module] = None,
                 scene_decoder: Optional[nn.Module] = None,
                 embedding_decoder: Optional[nn.Module] = None,
                 normal_decoder: Optional[nn.Module] = None):
        super().__init__()
        self.encoder = encoder
        self.context_module = context_module
        self.semantic_decoder = semantic_decoder
        self.instance_decoder = instance_decoder
        self.normal_decoder = normal_decoder
        self.scene_decoder = scene_decoder
        self.embedding_decoder = embedding_decoder

    def forward(self, inputs: dict,
                outputs: Optional[Sequence[str]] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """`outputs`: the task outputs to compute (None: all); a decoder
        nobody reads does not run, except in training mode, where it
        moves its BatchNorm statistics (`batch_statistics`, no
        gradient): the JAX package's training step returns them, and
        XLA drops the rest of the branch. `generator` feeds the random
        parts of training mode (on the model's device, or drawn on its
        own device and moved)."""
        enc_out, skips = self.encoder(inputs, generator)
        # the context module consumes the (fused) primary modality
        x = self.context_module(enc_out['rgb'] if 'rgb' in enc_out
                                else next(iter(enc_out.values())))
        result = {}
        for task, dec in (('semantic', self.semantic_decoder),
                          ('instance', self.instance_decoder),
                          ('normal', self.normal_decoder),
                          ('scene', self.scene_decoder),
                          ('dense_visual_embedding',
                           self.embedding_decoder)):
            if dec is None:
                continue
            if outputs is None or task in outputs:
                result[task] = dec(x, skips, generator)
            elif self.training:
                with torch.no_grad():
                    dec.batch_statistics(x, skips, generator)
        return result


def _build_encoder(c: MultiTaskModelConfig, g, rgbd_backbone=None):
    """The fused rgb + depth encoder, or one backbone's (rgbd, or the
    one of rgb and depth that the config names), as the JAX package's
    `get_encoder`."""
    def backbone(name, n_in):
        return get_backbone(name, resnet_block=c.resnet_block,
                            n_input_channels=n_in,
                            normalization=c.normalization,
                            activation=c.activation,
                            stochastic_depth=c.stochastic_depth,
                            attn_backend=c.backbone_attn_backend,
                            remat=c.backbone_remat,
                            attn_chunk_size=c.backbone_attn_chunk_size,
                            generator=g)
    if rgbd_backbone is not None:
        return Encoder(rgbd_backbone, c.skip_downsamplings)
    if c.backbone_rgbd is not None:
        return Encoder(backbone(c.backbone_rgbd, 4), c.skip_downsamplings)
    if c.backbone_rgb is None and c.backbone_depth is None:
        raise ValueError('Either `backbone_rgb` and/or `backbone_depth` or '
                         '`backbone_rgbd` must be given.')
    if c.backbone_depth is None:
        return Encoder(backbone(c.backbone_rgb, 3), c.skip_downsamplings)
    if c.backbone_rgb is None:
        return Encoder(backbone(c.backbone_depth, 1), c.skip_downsamplings)
    return FusedRGBDEncoder(
        backbone(c.backbone_rgb, 3), backbone(c.backbone_depth, 1),
        fusion=c.encoder_fusion, act=c.activation,
        skip_downsamplings=c.skip_downsamplings, generator=g)


def build_model(config: MultiTaskModelConfig, device=None,
                seed: int = 0, rgbd_backbone=None,
                train: bool = False) -> MultiTaskModel:
    """Build the model, randomly initialised from `seed`, on `device`
    (default `cuda`), in eval mode, or with `train=True` in training
    mode with the parameters only training has (the dense decoders'
    side heads, as in the JAX package's `init(..., train=True)`).
    `rgbd_backbone`: a 4-channel backbone module to use in place of the
    one the config names (for example a narrower Swin); the rest of the
    model is sized from it."""
    device = resolve_device(device)
    c = config
    tasks = set(c.tasks)
    unknown = sorted(tasks - set(KNOWN_TASKS))
    if unknown:
        raise ValueError(f'Unknown tasks {unknown}; the known tasks are '
                         f'{KNOWN_TASKS}')
    if 'orientation' in tasks and not tasks & {'instance', 'panoptic'}:
        raise ValueError("the 'orientation' task is a head of the instance "
                         "decoder: name 'instance' or 'panoptic' with it")
    g = torch.Generator().manual_seed(seed)
    encoder = _build_encoder(c, g, rgbd_backbone)
    ds_in = encoder.downsampling
    context = get_context_module(
        c.context_module, encoder.n_channels_out, c.context_n_channels,
        input_size=(c.input_size[0] // ds_in, c.input_size[1] // ds_in),
        normalization=c.normalization, activation=c.activation,
        generator=g)

    # decoders consume skips in descending downsampling order
    ds_to_channels = dict(zip(encoder.skips_downsamplings,
                              encoder.skips_n_channels))
    fusion_downsamplings = tuple(sorted(encoder.skips_downsamplings,
                                        reverse=True))
    fusion_n_channels = tuple(ds_to_channels[ds]
                              for ds in fusion_downsamplings)
    is_mlp = c.decoder_type == 'mlp'
    # a single-backbone encoder has one (lazily resolved) skip modality
    ed_fusion = c.encoder_decoder_fusion
    if isinstance(encoder, Encoder):
        ed_fusion = ed_fusion.replace('-rgb', '').replace('-depth', '')
    common = dict(
        n_channels_in=c.context_n_channels,
        downsampling_in=ds_in,
        fusion=ed_fusion, fusion_n_channels=fusion_n_channels,
        fusion_downsamplings=fusion_downsamplings,
        norm=c.normalization, act=c.activation,
        upsampling=c.upsampling,
        prediction_upsampling=c.prediction_upsampling,
    )
    if is_mlp:
        common['n_channels'] = (c.decoder_n_channels[0],) + tuple(
            c.decoder_n_channels[:len(fusion_n_channels)])
        common['dropout_p'] = c.decoder_dropout
    else:
        common.update(n_channels=c.decoder_n_channels,
                      downsamplings=c.decoder_downsamplings,
                      block=c.decoder_block, n_blocks=c.decoder_n_blocks,
                      side_heads=train, remat=c.decoder_remat)
    semantic = instance = normal = scene = embedding = None
    if tasks & {'semantic', 'panoptic'}:
        semantic = (SemanticMLPDecoder if is_mlp else SemanticDecoder)(
            n_classes=c.semantic_n_classes,
            defer_prediction_upsampling=(
                c.defer_semantic_prediction_upsampling),
            generator=g, **common)
    if tasks & {'instance', 'panoptic'}:
        instance = (InstanceMLPDecoder if is_mlp else InstanceDecoder)(
            with_orientation='orientation' in tasks, generator=g,
            **common)
    if 'normal' in tasks:
        normal = (NormalMLPDecoder if is_mlp else NormalDecoder)(
            generator=g, **common)
    if 'scene' in tasks:
        # a pooling context's global branch has n_channels_in //
        # len(bins) channels; without branches the decoder pools the
        # context output (context_n_channels)
        n_scene = (encoder.n_channels_out // len(context.bins)
                   if context.bins else c.context_n_channels)
        scene = SceneClassificationDecoder(n_scene, c.scene_n_classes,
                                           generator=g)
    if 'dense_visual_embedding' in tasks:
        embedding = (EmbeddingMLPDecoder if is_mlp else EmbeddingDecoder)(
            embedding_dim=c.embedding_dim, generator=g, **common)
    model = MultiTaskModel(encoder, context, semantic, instance, scene,
                           embedding, normal)
    return model.train(train).to(device)
