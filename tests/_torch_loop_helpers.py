"""Shared by the tests of the port's training loop (test_torch_train_
loop.py, test_torch_train_host.py): the JAX example's training
preprocessing (examples/train_synthetic.py:71-90, built inline there),
which the port's `train_preprocessing` is held against, and the
comparison of host samples and batches."""
import numpy as np

H, W = 64, 96
IS_THING = tuple(i in (1, 2, 3) for i in range(11))


def train_compose(p, H=H, W=W, normals=False):
    """The JAX example's training preprocessing, from the preprocessing
    package `p`, at (H, W); with `normals` the surface normals cloned
    and sub-sampled like the maps."""
    extra = ('normal',) if normals else ()
    return p.Compose([
        p.InstanceClearStuffIDs(semantic_classes_is_thing=IS_THING),
        p.FullResCloner(('rgb', 'depth', 'semantic', 'instance') + extra),
        p.Resize(height=H, width=W),
        p.RandomHSVJitter(0.05, 0.1, 0.1),
        p.RandomHorizontalFlip(p=0.5),
        p.MultiscaleSupervisionGenerator(
            downscales=(4, 8, 16, 32),
            keys=('semantic', 'instance', 'orientations') + extra),
        p.InstanceTargetGenerator(
            sigma=8, semantic_classes_is_thing=IS_THING,
            sigma_for_additional_downscales={4: 2, 8: 2, 16: 1, 32: 1}),
        p.OrientationTargetGenerator(
            semantic_classes_estimate_orientation=IS_THING),
        p.PanopticTargetGenerator(semantic_classes_is_thing=IS_THING),
        p.NormalizeRGB(),
        p.NormalizeDepth(depth_mean=8000.0, depth_std=4000.0,
                         raw_depth=True),
        p.ToDeviceArrays(),
    ])


def _same(a, b, where=''):
    """Host batches bit-equal: same keys, types, dtypes and values."""
    if isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f'{where}/{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            if isinstance(x, dict) and 'segment_table_overflow_fullres' in x:
                # the port also counts the full-resolution table's overflow
                x = {k: v for k, v in x.items()
                     if k != 'segment_table_overflow_fullres'}
            _same(x, y, f'{where}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if where == '/rgb':      # normalised: the port multiplies by 1/std
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)
