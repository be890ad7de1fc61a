"""Serving example (counterpart of the JAX package's
examples/infer_panoptic.py), on the card unless `--cpu`: uint8 RGB +
uint16 depth -> `PanopticInferencePipeline` (normalisation, forward,
centre NMS, grouping, merge) -> panoptic, semantic and instance maps
and scene logits, and three images of them written as PNGs.

    python -m nicr_mtsa_tpu_torch.examples.infer_panoptic \\
        [--cpu] [--out DIR] [--size H W]

The input frame is the synthetic 512 x 512 RGB-D sample of
`testing.get_dummy_sample()`, resized on the host; the model (2x
ResNet-18 basic blocks, 11 classes of which 4 things) has random
weights from seed 0. The images are written by `data.png.write_png`
(`panoptic.png`, `semantic.png`, `depth.png` in `--out`, by default
the temporary directory's `mtsa_infer`)."""
import argparse
import os
import tempfile

import numpy as np

N_CLASSES = 11
IS_THING = tuple(i < 4 for i in range(N_CLASSES))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--cpu', action='store_true')
    parser.add_argument('--out', default=os.path.join(tempfile.gettempdir(),
                                                      'mtsa_infer'))
    parser.add_argument('--size', type=int, nargs=2, default=(128, 160))
    return parser.parse_args(argv)


def build_pipeline(H: int, W: int, device):
    """The example's model and serving postprocessing (threshold 0.1,
    NMS 3, top-k 16) in f32 on `device`."""
    import torch

    from ..models.multi_task import MultiTaskModelConfig, build_model
    from ..pipeline import PanopticInferencePipeline
    from ..postprocessing import (InstancePostprocessing,
                                  PanopticPostprocessing,
                                  SemanticPostprocessing)
    config = MultiTaskModelConfig(
        tasks=('semantic', 'instance', 'orientation', 'scene'),
        backbone_rgb='resnet18', backbone_depth='resnet18',
        resnet_block='basicblock', context_n_channels=128,
        decoder_n_channels=(64, 48, 32), decoder_n_blocks=1,
        upsampling='bilinear', prediction_upsampling='bilinear',
        input_size=(H, W), semantic_n_classes=N_CLASSES, scene_n_classes=5)
    post = PanopticPostprocessing(
        semantic_postprocessing=SemanticPostprocessing(),
        instance_postprocessing=InstancePostprocessing(
            heatmap_threshold=0.1, heatmap_nms_kernel_size=3,
            top_k_instances=16),
        semantic_classes_is_thing=IS_THING,
        semantic_class_has_orientation=IS_THING)
    return PanopticInferencePipeline(
        build_model(config, device=device, seed=0), post,
        compute_dtype=torch.float32)


def input_frame(H: int, W: int):
    """(rgb (1, H, W, 3) uint8, depth (1, H, W) uint16) of the dummy
    sample."""
    from ..data.preprocessing.resize import (resize_image_bilinear,
                                             resize_image_nearest)
    from ..testing.preprocessing import get_dummy_sample
    sample = get_dummy_sample()
    return (resize_image_bilinear(sample['rgb'], H, W)[None],
            resize_image_nearest(sample['depth'], H, W)[None])


def images(out: dict, depth: np.ndarray) -> dict:
    """{file name: (H, W, 3) uint8} of the first image's panoptic and
    semantic maps and of the input depth."""
    from ..visualization import (generate_semantic_colors,
                                 visualize_depth_pil, visualize_panoptic_pil,
                                 visualize_semantic_pil)
    colors = generate_semantic_colors(N_CLASSES + 1)
    return {
        'panoptic.png': visualize_panoptic_pil(
            out['panoptic'][0].cpu().numpy(),
            classes_is_thing=(False,) + IS_THING, classes_colors=colors),
        'semantic.png': visualize_semantic_pil(
            out['semantic_idx'][0].cpu().numpy(), colors=colors[1:]),
        'depth.png': visualize_depth_pil(depth[0])}


def main(argv=None) -> dict:
    """Serve one frame and write its images; returns {'outputs': the
    pipeline's outputs, 'images': the arrays written, 'out': the
    directory}."""
    args = parse_args(argv)
    from ..data.png import write_png
    from ..utils.device import resolve_device

    device = resolve_device('cpu' if args.cpu else None)
    H, W = args.size
    pipe = build_pipeline(H, W, device)
    rgb, depth = input_frame(H, W)
    out = pipe(rgb, depth)

    panoptic = out['panoptic'][0].cpu().numpy()
    semantic = out['semantic_idx'][0].cpu().numpy()
    print('panoptic ids:', sorted(np.unique(panoptic).tolist())[:12])
    print('semantic classes:', sorted(np.unique(semantic).tolist()))
    print('scene logits:',
          out['scene_logits'][0].float().cpu().numpy().round(2))
    os.makedirs(args.out, exist_ok=True)
    imgs = images(out, depth)
    for name, img in imgs.items():
        write_png(os.path.join(args.out, name), img)
    print('wrote', ' / '.join(imgs), 'to', args.out)
    return {'outputs': out, 'images': imgs, 'out': args.out}


if __name__ == '__main__':
    main()
