"""`bench.py --eval --segment-table-size 64` in the PyTorch/CUDA port:
the eval step's postprocessing and metric-state updates with GT segment
tables of 64 slots (the bench's default is 128) against the JAX
package's fused eval step, on the CPU in f32.

The batch: the JAX preprocessing chain of test_torch_eval_pipeline.py
with `PanopticTargetGenerator(segment_table_size=64)` (two dummy
samples of 512 x 512 resized to 96 x 128); the model: the small config
of _torch_port_helpers.py on shared weights. From the JAX step's raw
outputs the port's `evaluate_outputs` gives every integer state equal
and the float sums within rtol 1e-5 (the rule of
test_torch_eval_pipeline.py), the losses within rtol 1e-4; the port's
batch builder makes tables of 64 slots."""
import numpy as np
import jax
import pytest
import torch

import _torch_port_helpers as hp
from nicr_mtsa_tpu.data import mt_collate
from nicr_mtsa_tpu.data.preprocessing import (
    Compose, FullResCloner, InstanceClearStuffIDs, InstanceTargetGenerator,
    NormalizeDepth, NormalizeRGB, OrientationTargetGenerator,
    PanopticTargetGenerator, Resize, ToDeviceArrays,
)
from nicr_mtsa_tpu.data.preprocessing.base import APPLIED_PREPROCESSING_KEY
from nicr_mtsa_tpu.pipeline import (
    MultiTaskPipeline as JPipeline, default_postprocessors as j_post,
    strip_non_arrays as j_strip_non_arrays,
)
from nicr_mtsa_tpu.tasks import (
    InstanceTaskHelper, PanopticTaskHelper, SceneTaskHelper,
    SemanticTaskHelper,
)
from nicr_mtsa_tpu.testing import get_dummy_sample
from nicr_mtsa_tpu_torch.pipeline import (
    MultiTaskPipeline, default_postprocessors, eval_task_helpers,
)
from nicr_mtsa_tpu_torch.testing import build_eval_batch
from test_torch_eval_pipeline import _assert_states_match, _nchw, port_batch

torch.set_num_threads(2)
IS_THING = tuple(i < hp.N_THING for i in range(hp.N_CLASSES))
IS_THING_V = (False,) + IS_THING
TABLE = 64
RAW_KEYS = ('semantic_output', 'instance_output', 'scene_output')


def _jax_batch():
    pre = Compose([
        InstanceClearStuffIDs(semantic_classes_is_thing=IS_THING_V),
        FullResCloner(('rgb', 'depth', 'semantic', 'instance')),
        Resize(height=hp.H, width=hp.W),
        InstanceTargetGenerator(sigma=8,
                                semantic_classes_is_thing=IS_THING_V),
        OrientationTargetGenerator(
            semantic_classes_estimate_orientation=IS_THING_V),
        PanopticTargetGenerator(semantic_classes_is_thing=IS_THING_V,
                                segment_table_size=TABLE),
        NormalizeRGB(),
        NormalizeDepth(depth_mean=8000.0, depth_std=4000.0,
                       raw_depth=True),
        ToDeviceArrays(),
    ])
    samples = []
    for i in range(2):
        s = get_dummy_sample()
        if i:
            for k in ('rgb', 'depth', 'instance', 'semantic'):
                s[k] = np.ascontiguousarray(s[k][:, ::-1])
        s['scene'] = i + 1
        samples.append(pre(s))
    return mt_collate(samples)


@pytest.fixture(scope='module')
def run():
    jm = hp.jax_model(False)
    v = hp.shaped_variables(jm, seed=1)
    jpipe = JPipeline(
        model=jm,
        postprocessors=j_post(tasks=('semantic', 'instance', 'orientation',
                                     'scene', 'panoptic'),
                              semantic_classes_is_thing=IS_THING,
                              top_k_instances=64),
        task_helpers={
            'semantic': SemanticTaskHelper(n_classes=hp.N_CLASSES),
            'instance': InstanceTaskHelper(
                semantic_n_classes=hp.N_CLASSES + 1,
                semantic_classes_is_thing=IS_THING_V, top_k_instances=64),
            'panoptic': PanopticTaskHelper(
                semantic_n_classes=hp.N_CLASSES + 1,
                semantic_classes_is_thing=IS_THING_V),
            'scene': SceneTaskHelper(n_classes=10),
        })
    batch = _jax_batch()
    static = {APPLIED_PREPROCESSING_KEY: batch[APPLIED_PREPROCESSING_KEY]}
    states = {n: h.empty_metric_states()
              for n, h in jpipe.task_helpers.items()}
    with jax.default_matmul_precision('highest'):
        raw, losses, states = jpipe.make_fused_eval_step(
            static, output_keys=RAW_KEYS)(v['params'], v['batch_stats'],
                                          j_strip_non_arrays(batch), states)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return dict(batch=batch, static=static, raw=to_np(raw),
                losses=to_np(losses), states=to_np(states))


def test_states_at_table_64_match_jax(run):
    assert np.asarray(run['batch']['panoptic_segment_table_fullres']
                      ).shape == (2, TABLE)
    heat, offset, ori = run['raw']['instance_output']
    predictions = {
        'semantic': (_nchw(run['raw']['semantic_output']), ()),
        'instance': ((_nchw(heat), _nchw(offset), _nchw(ori)), ()),
        'scene': (torch.from_numpy(np.array(run['raw']['scene_output'])),
                  ())}
    tpipe = MultiTaskPipeline(
        hp.torch_model(False), default_postprocessors(
            ('semantic', 'instance', 'orientation', 'scene', 'panoptic'),
            IS_THING, top_k_instances=64),
        eval_task_helpers(hp.N_CLASSES, hp.N_THING, 64, 10))
    batch = dict(port_batch(run['batch']), **run['static'])
    _, losses, states = tpipe.evaluate_outputs(
        predictions, batch, tpipe.empty_metric_states())
    _assert_states_match(states, run['states'])
    assert float(states['instance']['pq']['tp_per_class'].sum()) > 0
    assert set(losses) == set(run['losses'])
    for k, want in run['losses'].items():
        np.testing.assert_allclose(float(losses[k]), want, rtol=1e-4,
                                   err_msg=k)


def test_batch_builder_makes_tables_of_64():
    eb = build_eval_batch(2, (hp.H, hp.W), (128, 128), hp.N_CLASSES,
                          IS_THING, seed=0, segment_table_size=TABLE,
                          device='cpu')
    table = eb.batch['panoptic_segment_table_fullres']
    assert tuple(table.shape) == (2, TABLE)
    assert eb.segment_table_overflow == 0
