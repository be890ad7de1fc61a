"""Shared by the data-path tests of the port (test_torch_data_*.py,
test_torch_dataset_eval_step.py): the repo's dataset fixture and the
eval preprocessing of `bench.py --eval --dataset`, built in either
package."""
from pathlib import Path

FIXTURE = Path(__file__).resolve().parent / 'fixtures' / 'mini_dataset'
SIGMAS = {4: 2, 8: 2, 16: 1, 32: 1}


def eval_compose(p, is_thing_v, H, W, table=128, stop_after=None):
    """The eval preprocessing of `bench.py --eval` (bench.py:213-232) in
    package `p` (the JAX package's or the port's `preprocessing`);
    `stop_after` ends it after the step of that name."""
    steps = [
        p.InstanceClearStuffIDs(semantic_classes_is_thing=is_thing_v),
        p.FullResCloner(('rgb', 'depth', 'semantic', 'instance')),
        p.Resize(height=H, width=W),
        p.MultiscaleSupervisionGenerator(
            downscales=(4, 8, 16, 32),
            keys=('semantic', 'instance', 'orientations')),
        p.InstanceTargetGenerator(
            sigma=8, semantic_classes_is_thing=is_thing_v,
            sigma_for_additional_downscales=SIGMAS),
        p.OrientationTargetGenerator(
            semantic_classes_estimate_orientation=is_thing_v),
        p.PanopticTargetGenerator(semantic_classes_is_thing=is_thing_v,
                                  segment_table_size=table),
        p.NormalizeRGB(),
        p.NormalizeDepth(depth_mean=8000.0, depth_std=4000.0,
                         raw_depth=True),
        p.ToDeviceArrays(),
    ]
    if stop_after is not None:
        names = [type(s).__name__ for s in steps]
        steps = steps[:names.index(stop_after) + 1]
    return p.Compose(steps)
