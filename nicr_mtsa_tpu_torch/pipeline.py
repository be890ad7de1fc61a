"""Pipelines (counterpart of nicr_mtsa_tpu/pipeline.py).

- `PanopticInferencePipeline`, the serving path: uint8 RGB + uint16
  depth in, panoptic, semantic and instance maps plus scene logits out
  (and, on request, the raw outputs of further heads such as the dense
  visual embedding). Normalisation, the forward pass, centre NMS,
  grouping and the merge all run on the model's device. It serves both
  families: `emsanet_bench_config` (EMSANet, the default; with
  `defer=True` the `--no-defer4x` variant and its 2x finisher) and
  `emsaformer_bench_config` (EMSAFormer on SwinV2-T-128 RGB-D; with
  `attn_backend='qkv'` the `--attn-qkv` variant). At the
  boundary the layouts are the JAX package's: rgb (B, H, W, 3) uint8,
  depth (B, H, W) uint16 (numpy arrays or torch tensors), output maps
  (B, H, W). Depth is converted to int32 at the boundary: torch's
  uint16 supports few operations.
- `MultiTaskPipeline.make_fused_eval_step`, the eval path: forward,
  postprocessing with full-resolution keys, the shared GT slot map,
  the eval losses and the metric-state updates of every task helper,
  with the states carried by the caller on the device, for both
  families of `bench.py --eval` (`build_eval_pipeline`; EMSAFormer on
  `emsaformer_eval_config` with its dense-visual-embedding task, the
  retrieval against the caller's class tables).
- `MultiTaskPipeline.train_step`, the training path of `bench.py
  --train` (`build_train_pipeline` on `emsanet_train_config`, the
  bench's default model, or `emsaformer_train_config`): the
  forward pass in training mode, the training pass-through of the
  postprocessing, the task losses and their sum, the gradients, the
  AdamW update (optim.py) and the new BatchNorm statistics. The model
  holds the parameters and statistics and the step updates them in
  place; the random parts draw from the caller's generator. With a
  `loss_weighting` (weighting/: DWA, RLW, fixed) the weighted keys'
  totals are scaled by the weights as they stand before the step, and
  their values move the weighting on after it (one host fetch of a few
  scalars a step; without a weighting the step does not sync).
- `MultiTaskPipeline.validation_step` / `validation_epoch_end`, the
  eager validation loop of `examples/train_synthetic.py`: the forward
  pass in eval mode under inference mode, the postprocessing of the
  keys the helpers read, and each helper's `validation_step`, which
  accumulates its own metric states (the fused step's device code, the
  GT angle tables walked from the batch's id dicts) and the MAE against
  the GT instances.

On the card the model runs channels-last (NHWC activations and conv
weights), cuDNN's fast layout."""
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .configs import BENCH_CONFIGS, emsaformer_dve_v2
from .data.fullres import get_fullres
from .data.preprocessing.normalize import RGB_MEAN, RGB_STD
from .models.encoder import Encoder
from .models.multi_task import (MultiTaskModel, MultiTaskModelConfig,
                                build_model)
from .ops.segments import ids_to_slots
from .optim import AdamW
from .tasks.base import TOTAL_LOSS_SUFFIX
from .postprocessing import (DenseVisualEmbeddingPostprocessing,
                             InstancePostprocessing, NormalPostprocessing,
                             PanopticPostprocessing, ScenePostprocessing,
                             SemanticPostprocessing)
from .tasks import (DenseVisualEmbeddingTaskHelper, InstanceTaskHelper,
                    NormalTaskHelper, PanopticTaskHelper, SceneTaskHelper,
                    SemanticTaskHelper)

def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        if a.dtype == np.uint16:
            a = a.view(np.int16)     # reinterpreted; unsigned restored below
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return a.to(device)


def _set_layout(model, device, channels_last=None) -> bool:
    """Put the model's conv weights channels-last on the card (or as
    asked): NHWC activations are cuDNN's fast layout there, and with
    NCHW weights the 1-channel depth input (whose NCHW and NHWC strides
    coincide) would keep its whole branch in NCHW."""
    if channels_last is None:
        channels_last = device.type == 'cuda'
    if channels_last:
        model.to(memory_format=torch.channels_last)
    return channels_last


def _input_key(model) -> Optional[str]:
    """The one input of a single-backbone encoder ('rgbd', 'rgb' or
    'depth' by its input channels), None for the fused rgb + depth
    encoder."""
    encoder = model.encoder
    if not isinstance(encoder, Encoder):
        return None
    return {4: 'rgbd', 1: 'depth'}.get(encoder.backbone.n_input_channels,
                                       'rgb')


def depth_to_int32(depth) -> torch.Tensor:
    """uint16 depth (numpy, or torch.uint16 / int16 bit pattern) ->
    int32 with the unsigned values."""
    if depth.dtype in (torch.uint16, torch.int16):
        d = depth.view(torch.int16) if depth.dtype == torch.uint16 \
            else depth
        return d.to(torch.int32) & 0xFFFF
    return depth.to(torch.int32)


class PanopticInferencePipeline:
    # the postprocessed keys the serving dict reads
    OUTPUT_KEYS = frozenset((
        'panoptic_segmentation_deeplab',
        'panoptic_segmentation_deeplab_semantic_idx',
        'panoptic_segmentation_deeplab_instance_idx',
        'semantic_segmentation_idx', 'semantic_segmentation_score'))

    def __init__(self, model: MultiTaskModel,
                 panoptic_postprocessing: PanopticPostprocessing,
                 depth_mean: float = 2841.94941272766,    # NYUv2 stats
                 depth_std: float = 1417.2594281672277,
                 compute_dtype=torch.bfloat16,
                 channels_last: bool = None,
                 extra_output_tasks: Sequence[str] = ()):
        """extra_output_tasks: further task heads ('normal',
        'dense_visual_embedding') whose raw main outputs (NCHW, at the
        input's resolution) are added as '<task>_output'; their decoders
        run only when asked for."""
        self.model = model
        self.post = panoptic_postprocessing
        self._depth_mean = float(depth_mean)
        self._depth_std = float(depth_std)
        self._compute_dtype = compute_dtype
        self.device = next(model.parameters()).device
        self._rgb_mean = torch.from_numpy(RGB_MEAN).to(self.device)
        self._rgb_std = torch.from_numpy(RGB_STD).to(self.device)
        self._channels_last = _set_layout(model, self.device, channels_last)
        self._extra_output_tasks = tuple(extra_output_tasks)
        self._outputs = ('semantic', 'instance', 'scene') \
            + self._extra_output_tasks
        self._input_key = _input_key(model)

    def preprocess(self, rgb_u8, depth_u16) -> dict:
        """NCHW {'rgb', 'depth'} in the compute dtype for a fused
        dual-backbone encoder, {'rgbd'} (the channel concat) for a
        single 4-channel backbone, or the one modality of a 3- or
        1-channel backbone; invalid depth (0) is set to 0 after
        scaling."""
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
        inputs = {'rgb': rgb, 'depth': depth}
        if self._input_key == 'rgbd':
            inputs = {'rgbd': torch.cat([rgb, depth], dim=1)}
        elif self._input_key is not None:
            inputs = {self._input_key: inputs[self._input_key]}
        return {k: v.contiguous(memory_format=fmt) for k, v in inputs.items()}

    @torch.inference_mode()
    def __call__(self, rgb_u8, depth_u16) -> dict:
        predictions = self.model(self.preprocess(rgb_u8, depth_u16),
                                 outputs=self._outputs)
        r_dict = self.post.postprocess(
            ((predictions['semantic'][0], predictions['instance'][0]),
             (predictions['semantic'][1], predictions['instance'][1])),
            keys=self.OUTPUT_KEYS)
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
        for task in self._extra_output_tasks:
            outputs[f'{task}_output'] = predictions[task][0]
        return outputs


def emsanet_bench_config(input_size: Optional[Tuple[int, int]] = None,
                         dtype: str = 'bfloat16', n_classes: int = 40,
                         defer='all', remat: bool = False,
                         quick: bool = False) -> MultiTaskModelConfig:
    """The `emsanet-bench` configuration of the JAX package's bench.py:
    2x ResNet-34 NBt1D, context 512, decoders (512, 256, 128) x 3
    blocks, learned-3x3-zeropad upsampling, 480 x 640 unless
    `input_size` says otherwise. Serving defers both
    semantic prediction upsamplings to the fused 4x finisher
    (`defer='all'`, `bench.py`'s default `--defer4x`); `defer=True` is
    `bench.py --no-defer4x`, the head applying the first upsampling
    and deferring the last to the fused 2x finisher; eval runs both in
    the head (`defer=False`). `remat` is `bench.py --remat`: the
    encoder's and the dense decoders' residual blocks recompute their
    activations in training. `quick` is `bench.py --quick`
    (`bench.py:558-568`): 128 x 160, 2x ResNet-18 with basic blocks,
    context 128, decoders (64, 48, 32) x 1 block."""
    if input_size is None:
        input_size = (128, 160) if quick else (480, 640)
    return MultiTaskModelConfig(
        tasks=('semantic', 'instance', 'orientation', 'scene'),
        backbone_rgb='resnet18' if quick else 'resnet34',
        backbone_depth='resnet18' if quick else 'resnet34',
        resnet_block='basicblock' if quick else 'nonbottleneck1d',
        context_n_channels=128 if quick else 512,
        decoder_n_channels=(64, 48, 32) if quick else (512, 256, 128),
        decoder_n_blocks=1 if quick else 3,
        input_size=tuple(input_size), semantic_n_classes=n_classes,
        scene_n_classes=10, upsampling='learned-3x3-zeropad',
        prediction_upsampling='learned-3x3-zeropad',
        defer_semantic_prediction_upsampling=defer,
        backbone_remat=remat, decoder_remat=remat, dtype=dtype)


def emsaformer_bench_config(input_size: Tuple[int, int] = (480, 640),
                            dtype: str = 'bfloat16',
                            attn_backend: str = 'auto',
                            remat: bool = False, attn_chunk: int = 0,
                            model: str = 'emsaformer_dve_v2'
                            ) -> MultiTaskModelConfig:
    """The `emsaformer_dve_v2` preset (40 classes; `model=
    'emsaformer_dve'`: the Swin v1 preset with 7 x 7 windows) as the JAX
    package's `bench.py --model emsaformer_dve_v2` serves it: multimodal
    SwinV2-T-128 RGB-D, MLP decoders, bilinear upsampling, both semantic
    prediction upsamplings deferred to the fused bilinear 4x finisher.
    `attn_backend='qkv'` is `bench.py --attn-qkv`: each Swin block's
    qkv product in torch and attention over the packed qkv
    (ops/cuda/window_attention_qkv.py) in place of the whole-sub-block
    kernel. `remat` is `bench.py --remat` (the Swin blocks recompute
    their activations in training; the MLP decoders have no residual
    blocks), `attn_chunk` is `--attn-chunk` (images per window-attention
    chunk, 0 for the whole batch)."""
    return dataclasses.replace(
        BENCH_CONFIGS[model](n_classes=40, input_size=tuple(input_size),
                             dtype=dtype),
        defer_semantic_prediction_upsampling='all',
        backbone_attn_backend=attn_backend, backbone_remat=remat,
        backbone_attn_chunk_size=attn_chunk)


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
                           device=None, seed: int = 0, n_thing: int = 8,
                           extra_output_tasks: Sequence[str] = ()
                           ) -> PanopticInferencePipeline:
    """Model of `config` (default `emsanet_bench_config()`; random
    weights from `seed`) + serving postprocessing on `device` (default
    `cuda`), computing in the config's dtype."""
    config = config or emsanet_bench_config()
    model = build_model(config, device=device, seed=seed)
    post = serving_postprocessing(config.semantic_n_classes, n_thing)
    return PanopticInferencePipeline(
        model, post, compute_dtype=config.torch_dtype,
        extra_output_tasks=extra_output_tasks)


# --- eval path --------------------------------------------------------------

def strip_non_arrays(batch: dict) -> dict:
    """Drop entries that are not (nested dicts of) tensors or arrays:
    provenance meta, ragged per-sample dicts, python objects."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            nested = strip_non_arrays(value)
            if nested:
                out[key] = nested
        elif isinstance(value, (torch.Tensor, np.ndarray)):
            out[key] = value
    return out


def _add_shared_gt_slots(full_batch: dict) -> None:
    """The GT PQ slot map, computed once per step (in place): the
    panoptic and the instance helper score against the same GT."""
    target = get_fullres(full_batch, 'panoptic')
    if 'panoptic_segment_table_fullres' not in full_batch or target is None:
        return
    full_batch['panoptic_gt_slots_fullres'] = ids_to_slots(
        target.to(torch.int32), full_batch['panoptic_segment_table_fullres'])


def default_postprocessors(tasks: Sequence[str],
                           semantic_classes_is_thing: Sequence[bool],
                           compute_scores: bool = False,
                           top_k_instances: int = 64,
                           heatmap_threshold: float = 0.1,
                           heatmap_nms_kernel_size: int = 3,
                           semantic_class_has_orientation=None,
                           *, debug: bool = False, **dve_kwargs) -> dict:
    """The per-task postprocessors of the enabled tasks
    (`semantic_classes_is_thing` without void), the JAX package's
    signature: `compute_scores` adds the panoptic postprocessor's dense
    scores; `dve_kwargs` go to the dense-visual-embedding postprocessor
    (its class tables). `debug` (keyword only, the port's) turns on the
    instance postprocessor's debug branches."""
    tasks = set(tasks)
    post = {}
    sem_post = SemanticPostprocessing()
    ins_post = InstancePostprocessing(
        heatmap_threshold=heatmap_threshold,
        heatmap_nms_kernel_size=heatmap_nms_kernel_size,
        top_k_instances=top_k_instances, debug=debug)
    if 'panoptic' in tasks or {'semantic', 'instance'} <= tasks:
        if semantic_class_has_orientation is None:
            semantic_class_has_orientation = semantic_classes_is_thing
        post['panoptic'] = PanopticPostprocessing(
            semantic_postprocessing=sem_post,
            instance_postprocessing=ins_post,
            semantic_classes_is_thing=tuple(semantic_classes_is_thing),
            semantic_class_has_orientation=tuple(
                semantic_class_has_orientation),
            compute_scores=compute_scores)
    else:
        if 'semantic' in tasks:
            post['semantic'] = sem_post
        if 'instance' in tasks:
            post['instance'] = ins_post
    if 'normal' in tasks:
        post['normal'] = NormalPostprocessing()
    if 'scene' in tasks:
        post['scene'] = ScenePostprocessing()
    if 'dense_visual_embedding' in tasks:
        post['dense_visual_embedding'] = DenseVisualEmbeddingPostprocessing(
            **dve_kwargs)
    return post


class MultiTaskPipeline:
    """Model + postprocessors + task helpers (+ the optimizer), wired
    into the training step and the fused eval step; the model computes
    in `compute_dtype`."""

    def __init__(self, model: MultiTaskModel, postprocessors: dict,
                 task_helpers: dict, compute_dtype=torch.float32,
                 channels_last: bool = None,
                 optimizer: Optional[AdamW] = None, loss_weighting=None):
        self.model = model
        self.postprocessors = postprocessors
        self.task_helpers = task_helpers
        self.loss_weighting = loss_weighting
        self.optimizer = optimizer or AdamW(1e-4)
        self.device = next(model.parameters()).device
        self._compute_dtype = compute_dtype
        self._channels_last = _set_layout(model, self.device, channels_last)
        self._input_key = _input_key(model)
        self._rgbd = self._input_key == 'rgbd'
        # the outputs the training losses read (the panoptic helper
        # computes none)
        self._loss_tasks = tuple(t for t in task_helpers if t != 'panoptic')

    def model_inputs(self, batch: dict) -> dict:
        """The model's NCHW inputs in the compute dtype (channels-last on
        the card): {'rgb', 'depth'}, or {'rgbd'} for a 4-channel
        backbone, concatenated from 'rgb' and 'depth' where the batch
        carries them apart (as every eval batch does), or the one
        modality of a single 3- or 1-channel backbone."""
        fmt = (torch.channels_last if self._channels_last
               else torch.contiguous_format)
        dt = self._compute_dtype
        if self._rgbd and 'rgbd' not in batch \
                and 'rgb' in batch and 'depth' in batch:
            inputs = {'rgbd': torch.cat([batch['rgb'].to(dt),
                                         batch['depth'].to(dt)], dim=1)}
        else:
            keys = (('rgb', 'depth') if self._input_key is None
                    else (self._input_key,))
            inputs = {k: batch[k].to(dt) for k in keys if k in batch}
        return {k: v.contiguous(memory_format=fmt) for k, v in inputs.items()}

    # --- training -----------------------------------------------------------
    def create_train_state(self) -> dict:
        """{'params', 'batch_stats' (the model's own tensors, updated in
        place by `train_step`), 'opt_state', 'step'}."""
        params = dict(self.model.named_parameters())
        return {'params': params,
                'batch_stats': dict(self.model.named_buffers()),
                'opt_state': self.optimizer.init(params),
                'step': torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def compute_losses(self, batch: dict, predictions: dict) -> dict:
        """Task losses of raw training outputs: the training
        postprocessing is a pass-through (the outputs under their task
        names; the panoptic postprocessor's semantic and instance ones
        stand for those of its tasks)."""
        predictions_post = {}
        panoptic = self.postprocessors.get('panoptic')
        for task, raw in predictions.items():
            post = self.postprocessors.get(task)
            if post is None and panoptic is not None \
                    and task in ('semantic', 'instance'):
                post = getattr(panoptic, f'_{task}_postprocessing')
            if post is not None:
                predictions_post.update(
                    post.postprocess(raw, batch, is_training=True))
        losses = {}
        for task, helper in self.task_helpers.items():
            if task != 'panoptic':
                losses.update(helper.compute_losses(batch, predictions_post))
        return losses

    @staticmethod
    def total_loss(losses: dict, weights: Optional[dict] = None):
        """Sum of the '*_total_loss' entries; with `weights`, those it
        names times their weight (rounded to f32, as the JAX step takes
        it), then the others (the JAX package's order)."""
        keys = [k for k in losses if k.endswith(TOTAL_LOSS_SUFFIX)]
        if weights is None:
            return sum(losses[k] for k in keys)
        return sum(float(np.float32(weights[k])) * losses[k]
                   for k in keys if k in weights) \
            + sum(losses[k] for k in keys if k not in weights)

    def train_step(self, state: dict, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   batch_idx: int = 0):
        """One optimizer step: forward in training mode (random parts
        from `generator`, on the model's device; a head no loss reads
        moves only its BatchNorm statistics), losses, gradients
        (left in the parameters' `.grad`), the AdamW update and the new
        BatchNorm statistics, in place. Returns (state, losses) with
        losses detached, 'total_loss' included; no host sync unless a
        `loss_weighting` takes the step's weighted losses (`batch_idx`,
        the step's index in its epoch, is the weighting's)."""
        self.model.train()
        params = state['params']
        for p in params.values():
            p.grad = None
        predictions = self.model(self.model_inputs(batch),
                                 outputs=self._loss_tasks,
                                 generator=generator)
        losses = self.compute_losses(batch, predictions)
        weighting = self.loss_weighting
        total = self.total_loss(
            losses, None if weighting is None else weighting.weights)
        del predictions
        total.backward()
        self.optimizer.step(params, {n: p.grad for n, p in params.items()},
                            state['opt_state'])
        state['step'] += 1
        losses['total_loss'] = total
        losses = {k: v.detach() for k, v in losses.items()}
        if weighting is not None:
            keys = list(weighting.weights)
            values = torch.stack([losses[k].float() for k in keys]).tolist()
            weighting.reduce_losses(dict(zip(keys, values)), batch_idx)
        return state, losses

    def postprocess_outputs(self, predictions: dict, batch: dict,
                            keys=None) -> dict:
        """Inference postprocessing of raw model outputs; `keys` limits
        the full-resolution outputs computed (None: all)."""
        predictions_post = {}
        for task, raw in predictions.items():
            post = self.postprocessors.get(task)
            if post is not None:
                predictions_post.update(post.postprocess(raw, batch,
                                                         keys=keys))
        if 'panoptic' in self.postprocessors and 'semantic' in predictions \
                and 'instance' in predictions:
            predictions_post.update(self.postprocessors['panoptic'].postprocess(
                ((predictions['semantic'][0], predictions['instance'][0]),
                 (predictions['semantic'][1], predictions['instance'][1])),
                batch, keys=keys))
        return predictions_post

    def _read_keys(self, output_keys) -> Optional[frozenset]:
        if output_keys is None:
            return None
        keys = set(output_keys)
        for helper in self.task_helpers.values():
            keys.update(helper.prediction_keys)
        return frozenset(keys)

    def evaluate_outputs(self, predictions: dict, batch: dict,
                         metric_states: Dict[str, object],
                         output_keys: Optional[Sequence[str]] = ()):
        """Postprocessing, the shared GT slot map, the eval losses and
        the metric-state updates on given raw model outputs: the fused
        eval step after its forward pass. Returns (predictions selected
        by `output_keys` (None: all), losses, new states)."""
        full_batch = dict(batch)
        predictions_post = self.postprocess_outputs(
            predictions, full_batch, self._read_keys(output_keys))
        _add_shared_gt_slots(full_batch)
        new_states = dict(metric_states)
        losses = {}
        for name, helper in self.task_helpers.items():
            if hasattr(helper, 'compute_losses'):
                losses.update(helper.compute_losses(full_batch,
                                                    predictions_post))
            new_states[name] = helper.update_metric_states(
                metric_states.get(name), full_batch, predictions_post)
        if output_keys is not None:
            predictions_post = {k: predictions_post[k] for k in output_keys}
        return predictions_post, losses, new_states

    def empty_metric_states(self, device=None) -> dict:
        """Zero states of every helper on `device` (default: the
        model's)."""
        device = self.device if device is None else torch.device(device)
        return {name: helper.empty_metric_states(device)
                for name, helper in self.task_helpers.items()}

    def make_fused_eval_step(self, static_batch: dict,
                             output_keys: Optional[Sequence[str]] = ()):
        """step(batch, metric_states) -> (predictions, losses, states):
        forward + `evaluate_outputs` under inference mode, no host sync.
        `static_batch` holds the non-tensor entries every batch shares
        (the Resize provenance); `output_keys` selects the returned
        predictions, () for a metric-only epoch (None: all). The JAX
        step also takes the parameters; here the model holds them."""
        @torch.inference_mode()
        def step(batch, metric_states):
            full_batch = dict(batch)
            full_batch.update(static_batch)
            self.model.eval()
            predictions = self.model(self.model_inputs(full_batch))
            return self.evaluate_outputs(predictions, full_batch,
                                         metric_states, output_keys)
        return step

    def validation_step(self, batch: dict, batch_idx: int = 0):
        """The eager validation step: forward in eval mode under
        inference mode, then `validate_outputs`. `batch` is the whole
        batch on the device (provenance and per-sample dicts included,
        as `move_batch_to_device` leaves them). Returns
        (predictions_post, losses, logs); the JAX step also takes the
        train state, here the model holds it."""
        self.model.eval()
        with torch.inference_mode():
            predictions = self.model(self.model_inputs(batch))
            return self.validate_outputs(predictions, batch, batch_idx)

    def validate_outputs(self, predictions: dict, batch: dict,
                         batch_idx: int = 0):
        """Postprocessing of the keys the helpers read, the shared GT
        slot map, then each helper's `validation_step` on given raw model
        outputs."""
        keys = set()
        for helper in self.task_helpers.values():
            keys.update(helper.prediction_keys, helper.validation_keys)
        full_batch = dict(batch)
        predictions_post = self.postprocess_outputs(predictions, full_batch,
                                                    frozenset(keys))
        _add_shared_gt_slots(full_batch)
        all_losses, all_logs = {}, {}
        for helper in self.task_helpers.values():
            losses, logs = helper.validation_step(full_batch, batch_idx,
                                                  predictions_post)
            all_losses.update(losses)
            all_logs.update(logs)
        return predictions_post, all_losses, all_logs

    def load_metric_states(self, states: dict) -> None:
        for name, helper in self.task_helpers.items():
            if name in states:
                helper.load_metric_states(states[name])

    def validation_epoch_end(self):
        """(artifacts, examples, logs) of all helpers, from the states
        of their eager steps or, after a fused epoch, the states they
        loaded."""
        artifacts, examples, logs = {}, {}, {}
        for helper in self.task_helpers.values():
            a, e, lg = helper.validation_epoch_end()
            artifacts.update(a)
            examples.update(e)
            logs.update(lg)
        return artifacts, examples, logs


def emsanet_train_config(input_size: Tuple[int, int] = (480, 640),
                         dtype: str = 'bfloat16', n_classes: int = 40,
                         remat: bool = False) -> MultiTaskModelConfig:
    """`emsanet-bench` as `bench.py --train` trains it (the default
    model): `emsanet_bench_config` with the semantic prediction
    upsampling in the head (`defer=False`); `remat`: `--remat`."""
    return emsanet_bench_config(input_size, dtype, n_classes, defer=False,
                                remat=remat)


def emsaformer_train_config(input_size: Tuple[int, int] = (480, 640),
                            dtype: str = 'bfloat16', remat: bool = False,
                            **overrides) -> MultiTaskModelConfig:
    """The `emsaformer_dve_v2` preset (40 classes) as `bench.py --train
    --model emsaformer_dve_v2` trains it: no deferred upsampling;
    `remat`: `--remat` (the Swin blocks recompute their activations);
    `overrides` replace further fields (for example
    `stochastic_depth=0.0, decoder_dropout=0.0`)."""
    return dataclasses.replace(
        emsaformer_dve_v2(n_classes=40, input_size=tuple(input_size),
                          dtype=dtype),
        defer_semantic_prediction_upsampling=False, backbone_remat=remat,
        **overrides)


def train_task_helpers(n_classes: int = 40, n_thing: int = 8,
                       top_k: int = 64, scene_n_classes: int = 10,
                       normal: bool = False) -> dict:
    """The task helpers of the JAX package's `bench.py --train`:
    semantic, instance (with void, the first `n_thing` classes are
    things) and scene; with `normal` also the surface normals' (L1)."""
    is_thing_v = (False,) + tuple(i < n_thing for i in range(n_classes))
    helpers = {
        'semantic': SemanticTaskHelper(n_classes=n_classes),
        'instance': InstanceTaskHelper(
            semantic_n_classes=n_classes + 1,
            semantic_classes_is_thing=is_thing_v, top_k_instances=top_k),
        'scene': SceneTaskHelper(n_classes=scene_n_classes),
    }
    if normal:
        helpers['normal'] = NormalTaskHelper()
    return helpers


def build_train_pipeline(config: MultiTaskModelConfig = None, device=None,
                         seed: int = 0, n_thing: int = 8, top_k: int = 64,
                         mu_dtype=None) -> MultiTaskPipeline:
    """The training pipeline of `bench.py --train` on `device` (default
    `cuda`): the model of `config` (default `emsaformer_train_config()`,
    `bench.py --model emsaformer_dve_v2`; `emsanet_train_config()` is
    the bench's default model; random weights from `seed`) in training
    mode, the postprocessors of the bench's tasks, its task helpers (and
    the normal task's where the config names it) and
    `AdamW(1e-4, mu_dtype=mu_dtype)` (`torch.bfloat16`: `bench.py
    --mu-bf16`), computing in the config's dtype."""
    config = config or emsaformer_train_config()
    model = build_model(config, device=device, seed=seed, train=True)
    n = config.semantic_n_classes
    normal = 'normal' in config.tasks
    post = default_postprocessors(
        ('semantic', 'instance', 'orientation', 'scene', 'panoptic')
        + (('normal',) if normal else ()),
        semantic_classes_is_thing=tuple(i < n_thing for i in range(n)),
        top_k_instances=top_k)
    return MultiTaskPipeline(
        model, post, train_task_helpers(n, n_thing, top_k,
                                        config.scene_n_classes, normal),
        compute_dtype=config.torch_dtype,
        optimizer=AdamW(1e-4, mu_dtype=mu_dtype))


def emsaformer_eval_config(input_size: Tuple[int, int] = (480, 640),
                           dtype: str = 'bfloat16') -> MultiTaskModelConfig:
    """The `emsaformer_dve_v2` preset (40 classes) as `bench.py --eval
    --model emsaformer_dve_v2` evaluates it: the semantic prediction
    upsampling in the head (eval defers nothing), the window attention
    on the whole-sub-block kernel as in serving."""
    return dataclasses.replace(
        emsaformer_dve_v2(n_classes=40, input_size=tuple(input_size),
                          dtype=dtype),
        defer_semantic_prediction_upsampling=False)


def _thing_classes(n_classes: int, n_thing: int,
                   is_thing: Optional[Sequence[bool]]) -> Tuple[bool, ...]:
    """`is_thing` (one flag a class, without void), else the first
    `n_thing` of `n_classes` classes as things."""
    if is_thing is None:
        return tuple(i < n_thing for i in range(n_classes))
    if len(is_thing) != n_classes:
        raise ValueError(f'is_thing has {len(is_thing)} flags for '
                         f'{n_classes} classes')
    return tuple(bool(t) for t in is_thing)


def eval_task_helpers(n_classes: int = 40, n_thing: int = 8,
                      top_k: int = 64, scene_n_classes: int = 10,
                      dense_visual_embedding: bool = False,
                      is_thing: Optional[Sequence[bool]] = None,
                      normal: bool = False,
                      store_examples: bool = False) -> dict:
    """The task helpers of the JAX package's `bench.py --eval`: the
    thing classes are `is_thing` (without void; a dataset's
    `semantic_label_list_without_void.classes_is_thing`), else the first
    `n_thing` classes; with `dense_visual_embedding` also the
    embedding's (cosine loss, retrieval mIoU), with `normal` the surface
    normals' (L1 loss, per-pixel RMSE). `store_examples`: every helper
    that has example images renders them in its eager step of batch
    0."""
    is_thing_v = (False,) + _thing_classes(n_classes, n_thing, is_thing)
    ex = dict(store_examples=store_examples)
    helpers = {
        'semantic': SemanticTaskHelper(n_classes=n_classes, **ex),
        'instance': InstanceTaskHelper(
            semantic_n_classes=n_classes + 1,
            semantic_classes_is_thing=is_thing_v, top_k_instances=top_k,
            **ex),
        'panoptic': PanopticTaskHelper(
            semantic_n_classes=n_classes + 1,
            semantic_classes_is_thing=is_thing_v, **ex),
        'scene': SceneTaskHelper(n_classes=scene_n_classes),
    }
    if dense_visual_embedding:
        helpers['dense_visual_embedding'] = DenseVisualEmbeddingTaskHelper(
            n_classes=n_classes, **ex)
    if normal:
        helpers['normal'] = NormalTaskHelper(**ex)
    return helpers


def build_eval_pipeline(config: MultiTaskModelConfig = None, device=None,
                        seed: int = 0, n_thing: int = 8, top_k: int = 64,
                        dve_tables=None,
                        is_thing: Optional[Sequence[bool]] = None,
                        compute_scores: bool = False, debug: bool = False,
                        store_examples: bool = False) -> MultiTaskPipeline:
    """The eval pipeline of `bench.py --eval` on `device` (default
    `cuda`): the model of `config` (default `emsanet-bench` with the
    semantic prediction upsampling in the head; `emsaformer_eval_config()`
    is `--model emsaformer_dve_v2`; random weights from `seed`), the
    tasks' postprocessors plus the panoptic helper, top-k `top_k`,
    computing in the config's dtype. The thing classes (also the
    classes with an orientation) are `is_thing` (without void; `bench.py
    --eval --dataset` takes them from the dataset's meta.json), else the
    first `n_thing`. A config with the dense-visual-embedding task
    needs `dve_tables`, the (text, visual-mean) class embedding tables,
    (C, D) each. `compute_scores` (the panoptic dense scores), `debug`
    (the instance postprocessor's debug branches) and `store_examples`
    (the helpers' example images) go to the postprocessors and helpers
    (`default_postprocessors`, `eval_task_helpers`)."""
    config = config or emsanet_bench_config(defer=False)
    with_dve = 'dense_visual_embedding' in config.tasks
    if with_dve and dve_tables is None:
        raise ValueError('the dense-visual-embedding task needs its class '
                         'tables: pass dve_tables=(text, visual_mean)')
    dve_kwargs = {}
    if with_dve:
        text, visual_mean = dve_tables
        dve_kwargs = dict(
            with_text_embeddings_per_class=True,
            text_embeddings_per_class=text,
            with_mean_visual_embedding_per_class=True,
            mean_visual_embedding_per_class=visual_mean)
    model = build_model(config, device=device, seed=seed)
    n = config.semantic_n_classes
    is_thing = _thing_classes(n, n_thing, is_thing)
    post = default_postprocessors(
        tuple(config.tasks) + ('panoptic',),
        semantic_classes_is_thing=is_thing, compute_scores=compute_scores,
        top_k_instances=top_k, debug=debug, **dve_kwargs)
    return MultiTaskPipeline(
        model, post, eval_task_helpers(n, n_thing, top_k,
                                       config.scene_n_classes, with_dve,
                                       is_thing, 'normal' in config.tasks,
                                       store_examples),
        compute_dtype=config.torch_dtype)
