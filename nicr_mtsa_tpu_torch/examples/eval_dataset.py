"""Evaluation on a recorded dataset (counterpart of the JAX package's
examples/eval_dataset.py), on the card unless `--cpu`: directory dataset
-> the eval preprocessing -> threaded loader -> the fused eval step
(forward, postprocessing, the panoptic merge, the PQ / mIoU / scene
metric states on the device) -> the metric report.

    python -m nicr_mtsa_tpu_torch.examples.eval_dataset \\
        --dataset tests/fixtures/mini_dataset --split valid [--cpu]
        [--batch-size 2] [--size 96 128] [--checkpoint PATH]

The dataset is a directory in the layout of `data/dataset.py` (the
repo's fixture by default). The model (2x ResNet-18 basic blocks,
context 64, decoders (64, 48, 32) with one block) has random weights
from seed 0 unless `--checkpoint` names a file of `save_checkpoint` or
a directory of `StepCheckpointManager` (its latest step), whose
parameters and BatchNorm statistics it loads (a training checkpoint's
side heads are left out). A JAX orbax checkpoint is not read."""
import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dataset', default='tests/fixtures/mini_dataset')
    parser.add_argument('--split', default='valid')
    parser.add_argument('--batch-size', type=int, default=2)
    parser.add_argument('--size', type=int, nargs=2, default=(96, 128))
    parser.add_argument('--cpu', action='store_true')
    parser.add_argument('--checkpoint', default='',
                        help='a checkpoint file of the port or a '
                             'directory of step checkpoints (random '
                             'weights otherwise)')
    return parser.parse_args(argv)


def eval_preprocessing(cfg, H: int, W: int):
    """The example's eval preprocessing at the model's size (H, W), from
    the dataset's config `cfg`."""
    from ..data.preprocessing import (
        Compose, FullResCloner, InstanceClearStuffIDs,
        InstanceTargetGenerator, MultiscaleSupervisionGenerator,
        NormalizeDepth, NormalizeRGB, OrientationTargetGenerator,
        PanopticTargetGenerator, Resize, ToDeviceArrays)
    is_thing_v = (False,) + tuple(
        cfg.semantic_label_list_without_void.classes_is_thing)
    return Compose([
        InstanceClearStuffIDs(semantic_classes_is_thing=is_thing_v),
        FullResCloner(('rgb', 'depth', 'semantic', 'instance')),
        Resize(height=H, width=W),
        MultiscaleSupervisionGenerator(
            downscales=(4, 8, 16, 32),
            keys=('semantic', 'instance', 'orientations')),
        InstanceTargetGenerator(sigma=8,
                                semantic_classes_is_thing=is_thing_v),
        OrientationTargetGenerator(
            semantic_classes_estimate_orientation=is_thing_v),
        PanopticTargetGenerator(semantic_classes_is_thing=is_thing_v),
        NormalizeRGB(),
        NormalizeDepth(depth_mean=cfg.depth_mean, depth_std=cfg.depth_std,
                       raw_depth=cfg.depth_mode == 'raw'),
        ToDeviceArrays(),
    ])


def make_pipeline(cfg, H: int, W: int, device):
    """The example's model (random weights from seed 0), postprocessing
    and task helpers (top-k 32) for the dataset's config `cfg`."""
    from ..models.multi_task import MultiTaskModelConfig, build_model
    from ..pipeline import MultiTaskPipeline, default_postprocessors
    from ..tasks import (InstanceTaskHelper, PanopticTaskHelper,
                         SceneTaskHelper, SemanticTaskHelper)
    without_void = cfg.semantic_label_list_without_void
    n_classes, is_thing = len(without_void), without_void.classes_is_thing
    is_thing_v = (False,) + tuple(is_thing)
    n_scenes = max(2, len(cfg.scene_label_list))
    model = build_model(MultiTaskModelConfig(
        tasks=('semantic', 'instance', 'orientation', 'scene'),
        backbone_rgb='resnet18', backbone_depth='resnet18',
        resnet_block='basicblock', context_n_channels=64,
        decoder_n_channels=(64, 48, 32), decoder_n_blocks=1,
        input_size=(H, W), semantic_n_classes=n_classes,
        scene_n_classes=n_scenes), device=device, seed=0)
    helpers = {
        'semantic': SemanticTaskHelper(n_classes=n_classes),
        'instance': InstanceTaskHelper(
            semantic_n_classes=n_classes + 1,
            semantic_classes_is_thing=is_thing_v, top_k_instances=32),
        'panoptic': PanopticTaskHelper(
            semantic_n_classes=n_classes + 1,
            semantic_classes_is_thing=is_thing_v),
        'scene': SceneTaskHelper(n_classes=n_scenes),
    }
    return MultiTaskPipeline(
        model, default_postprocessors(
            tasks=('semantic', 'instance', 'orientation', 'scene',
                   'panoptic'),
            semantic_classes_is_thing=is_thing, top_k_instances=32),
        helpers)


@torch.no_grad()
def load_weights(model, path: str) -> None:
    """The parameters and BatchNorm statistics of a checkpoint file of
    `save_checkpoint`, or of the latest step of a `StepCheckpointManager`
    directory, copied into `model` (each leaf checked; names the model
    lacks, such as a training model's side heads, left out)."""
    from ..parallel.checkpoint import (StepCheckpointManager, _copy_leaf,
                                       load_checkpoint)
    if os.path.isdir(path):
        state, _ = StepCheckpointManager(path).restore()
    else:
        state, _ = load_checkpoint(path)
    if state is None:
        raise FileNotFoundError(f'no checkpoint step in {path}')
    src = dict(state['params'], **state['batch_stats'])
    own = dict(model.named_parameters(), **dict(model.named_buffers()))
    missing = sorted(set(own) - set(src))
    if missing:
        raise ValueError(f'the checkpoint lacks {missing[:5]} '
                         f'({len(missing)} tensors)')
    for name, t in own.items():
        _copy_leaf(src[name], t, name)


def evaluate(pipeline, loader, device) -> dict:
    """The fused eval step over every batch of `loader`; returns the
    metric states."""
    from ..data import move_batch_to_device
    from ..data.fullres import APPLIED_PREPROCESSING_KEY
    from ..pipeline import strip_non_arrays
    step, states = None, pipeline.empty_metric_states()
    for host in loader:
        if step is None:
            step = pipeline.make_fused_eval_step(
                {APPLIED_PREPROCESSING_KEY:
                 host[APPLIED_PREPROCESSING_KEY]}, output_keys=())
        batch = strip_non_arrays(move_batch_to_device(host, device=device))
        _, _, states = step(batch, states)
    return states


def report(pipeline, states) -> dict:
    """The epoch logs of every helper from `states`; prints the scalar
    metrics as the JAX example does."""
    logs = {}
    for name, helper in pipeline.task_helpers.items():
        helper.load_metric_states(states[name])
        _, _, helper_logs = helper.validation_epoch_end()
        for k, v in sorted(helper_logs.items()):
            if np.ndim(v) == 0 and 'time' not in k:
                print(f'  {k}: {float(v):.4f}')
        logs.update(helper_logs)
    return logs


def main(argv=None) -> dict:
    """Evaluate and print the report; returns the epoch logs."""
    args = parse_args(argv)
    from ..data import DataLoader
    from ..data.dataset import get_dataset
    from ..utils.device import resolve_device

    device = resolve_device('cpu' if args.cpu else None)
    H, W = args.size
    ds = get_dataset(args.dataset, split=args.split)
    ds.preprocessor = eval_preprocessing(ds.config, H, W)
    pipeline = make_pipeline(ds.config, H, W, device)
    if args.checkpoint:
        load_weights(pipeline.model, args.checkpoint)
    loader = DataLoader(ds, batch_size=args.batch_size, num_workers=2)
    states = evaluate(pipeline, loader, device)
    print(f'evaluated {len(ds)} samples of {args.dataset}:{args.split}')
    return report(pipeline, states)


if __name__ == '__main__':
    main()
