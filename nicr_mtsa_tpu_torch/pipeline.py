"""Serving pipeline: uint8 RGB + uint16 depth in, panoptic, semantic and
instance maps plus scene logits out (counterpart of
nicr_mtsa_tpu/pipeline.py `PanopticInferencePipeline`).

Normalisation, the forward pass, centre NMS, grouping and the merge
all run on the model's device. At the boundary the layouts are the JAX
package's: rgb (B, H, W, 3) uint8, depth (B, H, W) uint16 (numpy
arrays or torch tensors), output maps (B, H, W). Depth is converted to
int32 at the boundary: torch's uint16 supports few operations."""
from typing import Tuple

import numpy as np
import torch

from .models.multi_task import (MultiTaskModel, MultiTaskModelConfig,
                                build_model)
from .postprocessing import (InstancePostprocessing, PanopticPostprocessing,
                             SemanticPostprocessing)

# ImageNet statistics scaled to [0, 255] (the JAX package's
# data/preprocessing/normalize.py RGB_MEAN / RGB_STD)
RGB_MEAN = np.float32(255) * np.array((0.485, 0.456, 0.406), 'float32')
RGB_STD = np.float32(255) * np.array((0.229, 0.224, 0.225), 'float32')


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        if a.dtype == np.uint16:
            a = a.view(np.int16)     # reinterpreted; unsigned restored below
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return a.to(device)


def depth_to_int32(depth) -> torch.Tensor:
    """uint16 depth (numpy, or torch.uint16 / int16 bit pattern) ->
    int32 with the unsigned values."""
    if depth.dtype in (torch.uint16, torch.int16):
        d = depth.view(torch.int16) if depth.dtype == torch.uint16 \
            else depth
        return d.to(torch.int32) & 0xFFFF
    return depth.to(torch.int32)


class PanopticInferencePipeline:
    def __init__(self, model: MultiTaskModel,
                 panoptic_postprocessing: PanopticPostprocessing,
                 depth_mean: float = 2841.94941272766,    # NYUv2 stats
                 depth_std: float = 1417.2594281672277,
                 compute_dtype=torch.bfloat16,
                 channels_last: bool = None):
        self.model = model
        self.post = panoptic_postprocessing
        self._depth_mean = float(depth_mean)
        self._depth_std = float(depth_std)
        self._compute_dtype = compute_dtype
        self.device = next(model.parameters()).device
        self._rgb_mean = torch.from_numpy(RGB_MEAN).to(self.device)
        self._rgb_std = torch.from_numpy(RGB_STD).to(self.device)
        # NHWC activations are cuDNN's fast layout on the card; the conv
        # weights go NHWC too, or the 1-channel depth input (whose NCHW
        # and NHWC strides coincide) keeps its whole branch in NCHW
        self._channels_last = (self.device.type == 'cuda'
                               if channels_last is None else channels_last)
        if self._channels_last:
            self.model.to(memory_format=torch.channels_last)

    def preprocess(self, rgb_u8, depth_u16) -> dict:
        """NCHW {'rgb', 'depth'} in the compute dtype; invalid depth
        (0) is set to 0 after scaling."""
        dev = self.device
        rgb = _as_tensor(rgb_u8, dev).float()
        rgb = (rgb - self._rgb_mean) / self._rgb_std
        depth = depth_to_int32(_as_tensor(depth_u16, dev)).float()
        invalid = depth == 0.0
        depth = (depth - self._depth_mean) / self._depth_std
        depth = torch.where(invalid, 0.0, depth)
        rgb = rgb.permute(0, 3, 1, 2).to(self._compute_dtype)
        depth = depth[:, None].to(self._compute_dtype)
        fmt = (torch.channels_last if self._channels_last
               else torch.contiguous_format)
        return {'rgb': rgb.contiguous(memory_format=fmt),
                'depth': depth.contiguous(memory_format=fmt)}

    @torch.inference_mode()
    def __call__(self, rgb_u8, depth_u16) -> dict:
        predictions = self.model(self.preprocess(rgb_u8, depth_u16))
        r_dict = self.post.postprocess(
            ((predictions['semantic'][0], predictions['instance'][0]),
             (predictions['semantic'][1], predictions['instance'][1])))
        outputs = {
            'panoptic': r_dict['panoptic_segmentation_deeplab'],
            'panoptic_semantic':
                r_dict['panoptic_segmentation_deeplab_semantic_idx'],
            'panoptic_instance':
                r_dict['panoptic_segmentation_deeplab_instance_idx'],
            'semantic_idx': r_dict['semantic_segmentation_idx'],
            'semantic_score': r_dict['semantic_segmentation_score'],
        }
        if 'scene' in predictions:
            outputs['scene_logits'] = predictions['scene'][0]
        return outputs


def emsanet_bench_config(input_size: Tuple[int, int] = (480, 640),
                         dtype: str = 'bfloat16',
                         n_classes: int = 40) -> MultiTaskModelConfig:
    """The `emsanet-bench` serving configuration of the JAX package's
    bench.py: 2x ResNet-34 NBt1D, context 512, decoders (512, 256, 128)
    x 3 blocks, learned-3x3-zeropad upsampling, both semantic
    prediction upsamplings deferred to the fused 4x finisher."""
    return MultiTaskModelConfig(
        tasks=('semantic', 'instance', 'orientation', 'scene'),
        backbone_rgb='resnet34', backbone_depth='resnet34',
        resnet_block='nonbottleneck1d', context_n_channels=512,
        decoder_n_channels=(512, 256, 128), decoder_n_blocks=3,
        input_size=tuple(input_size), semantic_n_classes=n_classes,
        scene_n_classes=10, upsampling='learned-3x3-zeropad',
        prediction_upsampling='learned-3x3-zeropad',
        defer_semantic_prediction_upsampling='all', dtype=dtype)


def serving_postprocessing(n_classes: int = 40, n_thing: int = 8,
                           top_k: int = 64) -> PanopticPostprocessing:
    """The bench's serving postprocessing: threshold 0.1, NMS 3, top-k
    64, the first `n_thing` classes are things (with orientation)."""
    is_thing = tuple(i < n_thing for i in range(n_classes))
    return PanopticPostprocessing(
        semantic_postprocessing=SemanticPostprocessing(),
        instance_postprocessing=InstancePostprocessing(
            heatmap_threshold=0.1, heatmap_nms_kernel_size=3,
            top_k_instances=top_k),
        semantic_classes_is_thing=is_thing,
        semantic_class_has_orientation=is_thing)


def build_serving_pipeline(config: MultiTaskModelConfig = None,
                           device=None, seed: int = 0,
                           n_thing: int = 8) -> PanopticInferencePipeline:
    """Model (random weights from `seed`) + serving postprocessing on
    `device` (default `cuda`), computing in the config's dtype."""
    config = config or emsanet_bench_config()
    model = build_model(config, device=device, seed=seed)
    post = serving_postprocessing(config.semantic_n_classes, n_thing)
    return PanopticInferencePipeline(model, post,
                                     compute_dtype=config.torch_dtype)
