"""Shared by the data-path tests of the port (test_torch_data_*.py,
test_torch_dataset_eval_step.py): the repo's dataset fixture, the
eval preprocessing of `bench.py --eval --dataset`, built in either
package, the JAX package's native library loaded in the worker
(`jax_native_loaded`, for every port test file whose JAX side runs
the JAX package's host transforms), and a bounded wait for a step
checkpoint's background write (`join_write`)."""
from pathlib import Path

import pytest

FIXTURE = Path(__file__).resolve().parent / 'fixtures' / 'mini_dataset'
SIGMAS = {4: 2, 8: 2, 16: 1, 32: 1}
# seconds a test waits for a background checkpoint write
WRITE_TIMEOUT_S = 120


def join_write(mgr):
    """Wait at most WRITE_TIMEOUT_S for the write `mgr` (a port
    `StepCheckpointManager`) has in flight, so that its next call
    (save, wait_until_finished, latest_step, restore) does not block."""
    thread = mgr._thread
    if thread is not None:
        thread.join(WRITE_TIMEOUT_S)
        assert not thread.is_alive(), \
            f'the checkpoint write ran past {WRITE_TIMEOUT_S} s'


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


@pytest.fixture(autouse=True, scope='module')
def jax_native_loaded():
    """The JAX package's native host library loaded in this process, as
    its transforms expect once built. On a checkout without
    native/libmtsa_preproc.so every xdist worker runs its build at
    once while collecting tests/test_native.py (a `native.available()`
    at import); a worker whose build or load fails meanwhile would keep
    the numpy fallback for the whole run, which rounds the bilinear
    resize and the HSV jitter otherwise than the native kernels the port
    is held to. The load is retried here, after collection."""
    from nicr_mtsa_tpu import native
    if native._LIB is None:
        native._TRIED = False
        native._load()
    yield
