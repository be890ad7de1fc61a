"""Training loop on synthetic data (counterpart of the JAX package's
examples/train_synthetic.py), on the card unless `--cpu`:

  synthetic RGB-D dataset -> training preprocessing with augmentation
  (HSV jitter, horizontal flip) -> threaded loader -> prefetch to the
  device -> multi-task train step under DWA loss weighting -> eager
  validation steps (PQ, mIoU, scene accuracy and the orientation MAE
  against the GT instances) -> checkpoint policy, checkpoints with the
  DWA state, CSV log.

    python -m nicr_mtsa_tpu_torch.examples.train_synthetic \\
        --epochs 2 --steps 4 [--batch-size 2] [--size 96 128] [--cpu]

As in the JAX example the validation runs over the training loader,
augmentation included. Each sample's augmentation draws from its own
generator, seeded by (0, pass over the loader, index).

The chain's parts are functions of their own (`train_preprocessing`,
`make_pipeline`, `train_epoch`, `validate`, `end_epoch`, `save_epoch`),
so that a larger model or other loaders can run the same loop."""
import argparse
import os
import tempfile

import torch

# 10 classes and void; classes 1-3 are things with an orientation
IS_THING = tuple(i in (1, 2, 3) for i in range(11))
SCENE_N_CLASSES = 5
DWA_KEYS = ('semantic_total_loss', 'instance_center_total_loss',
            'instance_offset_total_loss', 'instance_orientation_total_loss',
            'scene_total_loss')


def train_preprocessing(H: int, W: int, normals: bool = False):
    """The training preprocessing at the model's size (H, W); with
    `normals` the samples' surface normals (`normal`, (H, W, 3) f32)
    are cloned at full resolution and sub-sampled for the side outputs
    like the maps (the flip mirrors them as an image and keeps the sign
    of x, as the JAX package's does)."""
    from ..data.preprocessing import (
        Compose, FullResCloner, InstanceClearStuffIDs,
        InstanceTargetGenerator, MultiscaleSupervisionGenerator,
        NormalizeDepth, NormalizeRGB, OrientationTargetGenerator,
        PanopticTargetGenerator, RandomHorizontalFlip, RandomHSVJitter,
        Resize, ToDeviceArrays)
    extra = ('normal',) if normals else ()
    return Compose([
        InstanceClearStuffIDs(semantic_classes_is_thing=IS_THING),
        FullResCloner(('rgb', 'depth', 'semantic', 'instance') + extra),
        Resize(height=H, width=W),
        RandomHSVJitter(0.05, 0.1, 0.1),
        RandomHorizontalFlip(p=0.5),
        MultiscaleSupervisionGenerator(
            downscales=(4, 8, 16, 32),
            keys=('semantic', 'instance', 'orientations') + extra),
        InstanceTargetGenerator(
            sigma=8, semantic_classes_is_thing=IS_THING,
            sigma_for_additional_downscales={4: 2, 8: 2, 16: 1, 32: 1}),
        OrientationTargetGenerator(
            semantic_classes_estimate_orientation=IS_THING),
        PanopticTargetGenerator(semantic_classes_is_thing=IS_THING),
        NormalizeRGB(),
        NormalizeDepth(depth_mean=8000.0, depth_std=4000.0, raw_depth=True),
        ToDeviceArrays(),
    ])


def make_pipeline(model, config):
    """The pipeline of a model built from `config` (10 semantic classes,
    5 scenes): its postprocessing and task helpers (top-k 32), AdamW
    (3e-4) and DWA over the five task losses; where the config names
    the 'normal' task also its helper (L1) and its loss under DWA."""
    from ..optim import AdamW
    from ..pipeline import MultiTaskPipeline, default_postprocessors
    from ..tasks import (InstanceTaskHelper, NormalTaskHelper,
                         PanopticTaskHelper, SceneTaskHelper,
                         SemanticTaskHelper)
    from ..weighting import DynamicWeightAverage
    n_classes_with_void = len(IS_THING)
    normal = 'normal' in config.tasks
    return MultiTaskPipeline(
        model=model,
        postprocessors=default_postprocessors(
            tasks=config.tasks + ('panoptic',),
            semantic_classes_is_thing=IS_THING[1:], top_k_instances=32),
        task_helpers={
            'semantic': SemanticTaskHelper(
                n_classes=n_classes_with_void - 1),
            'instance': InstanceTaskHelper(
                semantic_n_classes=n_classes_with_void,
                semantic_classes_is_thing=IS_THING, top_k_instances=32),
            'panoptic': PanopticTaskHelper(
                semantic_n_classes=n_classes_with_void,
                semantic_classes_is_thing=IS_THING),
            'scene': SceneTaskHelper(n_classes=SCENE_N_CLASSES),
            **({'normal': NormalTaskHelper()} if normal else {}),
        },
        loss_weighting=DynamicWeightAverage(
            DWA_KEYS + (('normal_total_loss',) if normal else ())),
        optimizer=AdamW(3e-4), compute_dtype=config.torch_dtype)


def train_epoch(pipeline, state, loader, epoch: int, device):
    """One pass over `loader`, prefetched to `device`, one weighted train
    step a batch (random parts seeded by epoch * 1000 + batch index).
    Returns (state, the last step's losses)."""
    from ..data import prefetch_to_device
    from ..pipeline import strip_non_arrays
    losses = None
    for batch_idx, batch in enumerate(prefetch_to_device(loader,
                                                         device=device)):
        generator = torch.Generator(device).manual_seed(
            epoch * 1000 + batch_idx)
        state, losses = pipeline.train_step(
            state, strip_non_arrays(batch), generator, batch_idx=batch_idx)
    return state, losses


def validate(pipeline, loader, device):
    """The helpers' eager validation steps over `loader`."""
    from ..data import prefetch_to_device
    for batch_idx, batch in enumerate(prefetch_to_device(loader,
                                                         device=device)):
        pipeline.validation_step(batch, batch_idx=batch_idx)


def end_epoch(pipeline, epoch: int, train_loss: float, ckpt_helper,
              logger):
    """The validation epoch's metrics, logged with the train loss and
    printed. Returns (logs, the metrics the checkpoint policy would save
    for)."""
    from ..utils import cprint_step
    _, _, metrics = pipeline.validation_epoch_end()
    logs = {'epoch': epoch, 'train_total_loss': train_loss}
    logs.update({f'valid_{k}': float(v) for k, v in metrics.items()
                 if torch.as_tensor(v).ndim == 0})
    to_save = ckpt_helper.check_for_checkpoint(logs)
    logger.log(logs)
    miou = logs.get('valid_semantic_miou', float('nan'))
    pq = logs.get('valid_panoptic_all_deeplab_pq', float('nan'))
    weights = {k: round(v, 2)
               for k, v in pipeline.loss_weighting.weights.items()}
    cprint_step(f'epoch {epoch}: loss={train_loss:.3f} miou={miou:.3f} '
                f'pq={pq:.3f} dwa={weights}')
    return logs, to_save


def save_epoch(pipeline, state, epoch: int, out: str) -> str:
    """The train state's checkpoint `<out>/ckpt_epoch<epoch>`, with the
    epoch and the DWA state. Returns its path."""
    from ..parallel.checkpoint import save_checkpoint
    return save_checkpoint(
        os.path.join(out, f'ckpt_epoch{epoch}'), state,
        extra={'epoch': epoch, 'dwa': pipeline.loss_weighting.state_dict()})


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--epochs', type=int, default=2)
    parser.add_argument('--steps', type=int, default=4)
    parser.add_argument('--batch-size', type=int, default=2)
    parser.add_argument('--size', type=int, nargs=2, default=(96, 128))
    parser.add_argument('--cpu', action='store_true')
    parser.add_argument('--out',
                        default=os.path.join(tempfile.gettempdir(),
                                             'mtsa_run'))
    args = parser.parse_args()

    from ..data import DataLoader, mt_collate
    from ..models.multi_task import MultiTaskModelConfig, build_model
    from ..testing.dataset import get_dataset
    from ..utils import CheckpointHelper, CSVLogger, cprint
    from ..utils.device import resolve_device

    device = resolve_device('cpu' if args.cpu else None)
    H, W = args.size

    dataset = get_dataset(preprocessor=train_preprocessing(H, W),
                          n_samples=args.steps * args.batch_size,
                          height=2 * H, width=2 * W)
    loader = DataLoader(dataset, batch_size=args.batch_size, num_workers=2,
                        collate_fn=mt_collate, drop_last=True, seed=0)

    config = MultiTaskModelConfig(
        tasks=('semantic', 'instance', 'orientation', 'scene'),
        backbone_rgb='resnet18', backbone_depth='resnet18',
        resnet_block='basicblock', context_n_channels=128,
        decoder_n_channels=(64, 48, 32), decoder_n_blocks=1,
        upsampling='bilinear', prediction_upsampling='bilinear',
        input_size=(H, W), semantic_n_classes=len(IS_THING) - 1,
        scene_n_classes=SCENE_N_CLASSES)
    pipeline = make_pipeline(
        build_model(config, device=device, seed=0, train=True), config)

    os.makedirs(args.out, exist_ok=True)
    logger = CSVLogger(os.path.join(args.out, 'log.csv'))
    ckpt_helper = CheckpointHelper(metric_names=('valid_semantic_miou',
                                                'panoptic_all_deeplab_pq'),
                                   debug=False)
    state = pipeline.create_train_state()

    for epoch in range(args.epochs):
        state, losses = train_epoch(pipeline, state, loader, epoch, device)
        # as in the JAX example the validation reads the training loader
        validate(pipeline, loader, device)
        _, to_save = end_epoch(pipeline, epoch, float(losses['total_loss']),
                               ckpt_helper, logger)
        if to_save:
            path = save_epoch(pipeline, state, epoch, args.out)
            cprint(f'  checkpoint -> {path} ({sorted(to_save)})',
                   color='green')

    logger.write()
    print('done; log at', os.path.join(args.out, 'log.csv'))


if __name__ == '__main__':
    main()
