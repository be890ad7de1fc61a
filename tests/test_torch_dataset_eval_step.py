"""The fused eval step of `bench.py --eval --dataset
tests/fixtures/mini_dataset` in the PyTorch/CUDA port against the JAX
package, on the CPU in f32.

Each package reads the fixture's `valid` split (B = 2) through its own
dataset, eval preprocessing, collate and hand-off; the model is
`bench.py --quick`'s EMSANet (resnet18 BasicBlock encoders, context
128, decoders (64, 48, 32), one block) at 96 x 128 with the dataset's
10 classes, of which meta.json's 3 are things, on one set of weights
(the flax tree shaped by `jax.eval_shape` and filled from the port's
seeded model, norms randomised).

- From the JAX step's raw outputs, the port's postprocessing and metric
  updates on the port's batch give states equal to the JAX step's:
  integers exactly, float sums within rtol 1e-5; losses within rtol
  1e-4.
- The port's own fused step: its semantic confusion matrix within
  0.1 % of the counted pixels of the JAX step's (another summation
  order flips near-tie pixels), every epoch metric in range."""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import torch

from nicr_mtsa_tpu.data import mt_collate as j_collate
from nicr_mtsa_tpu.data import preprocessing as jpre
from nicr_mtsa_tpu.data.dataset import DirectoryRGBDDataset as JDataset
from nicr_mtsa_tpu.models.multi_task import (MultiTaskModelConfig as JConfig,
                                             build_model as jax_build)
from nicr_mtsa_tpu.pipeline import (MultiTaskPipeline as JPipeline,
                                    default_postprocessors as j_post,
                                    strip_non_arrays as j_strip)
from nicr_mtsa_tpu.tasks import (InstanceTaskHelper, PanopticTaskHelper,
                                 SceneTaskHelper, SemanticTaskHelper)
from nicr_mtsa_tpu_torch.data import (DirectoryRGBDDataset,
                                      move_batch_to_device, mt_collate)
from nicr_mtsa_tpu_torch.data import preprocessing as pre
from nicr_mtsa_tpu_torch.pipeline import (build_eval_pipeline,
                                          emsanet_bench_config,
                                          strip_non_arrays)
from nicr_mtsa_tpu_torch.utils import flax_weights as fw
from _torch_data_helpers import FIXTURE, eval_compose
from _torch_emsanet_train_helpers import QUICK
from _torch_train_helpers import randomise_norms

torch.set_num_threads(2)
H, W, B = 96, 128, 2
RAW_KEYS = ('semantic_output', 'instance_output', 'scene_output')


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _assert_states_match(got, want, name=''):
    if isinstance(want, dict):
        assert set(got) == set(want), name
        for k in want:
            _assert_states_match(got[k], want[k], f'{name}/{k}')
        return
    got = got.numpy()
    if name.endswith(('iou_per_class', 'sum_angular_error')):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_dataset_fused_eval_step_matches_jax():
    ds = DirectoryRGBDDataset(str(FIXTURE), split='valid')
    without_void = ds.config.semantic_label_list_without_void
    n_classes, is_thing = len(without_void), without_void.classes_is_thing
    is_thing_v = (False,) + is_thing
    assert n_classes == 10 and sum(is_thing) == 3

    # the port: dataset -> Compose -> collate -> the device batch
    compose = eval_compose(pre, is_thing_v, H, W)
    host = mt_collate([compose(ds[i]) for i in range(B)])
    static = {pre.APPLIED_PREPROCESSING_KEY:
              host[pre.APPLIED_PREPROCESSING_KEY]}
    batch = strip_non_arrays(move_batch_to_device(host, device='cpu'))
    assert pre.segment_table_overflow(host) == 0
    cfg = dataclasses.replace(
        emsanet_bench_config((H, W), 'float32', n_classes, defer=False),
        **QUICK)
    tpipe = build_eval_pipeline(cfg, device='cpu', is_thing=is_thing)

    # the JAX package on its own data path and the same weights
    jds = JDataset(str(FIXTURE), split='valid')
    jcompose = eval_compose(jpre, is_thing_v, H, W)
    jbatch = j_collate([jcompose(jds[i]) for i in range(B)])
    jm = jax_build(JConfig(
        tasks=('semantic', 'instance', 'orientation', 'scene'),
        input_size=(H, W), semantic_n_classes=n_classes, scene_n_classes=10,
        upsampling='learned-3x3-zeropad',
        prediction_upsampling='learned-3x3-zeropad',
        defer_semantic_prediction_upsampling=False, **QUICK))
    template = jax.eval_shape(lambda: jm.init(
        {'params': jax.random.PRNGKey(0)},
        {'rgb': jnp.zeros((1, H, W, 3)), 'depth': jnp.zeros((1, H, W, 1))},
        train=False))
    v = fw.torch_to_flax_variables(tpipe.model, template)
    randomise_norms(v, np.random.default_rng(3))
    fw.load_flax_variables(tpipe.model, v)
    jpipe = JPipeline(
        model=jm,
        postprocessors=j_post(
            tasks=('semantic', 'instance', 'orientation', 'scene',
                   'panoptic'),
            semantic_classes_is_thing=is_thing, top_k_instances=64),
        task_helpers={
            'semantic': SemanticTaskHelper(n_classes=n_classes),
            'instance': InstanceTaskHelper(
                semantic_n_classes=n_classes + 1,
                semantic_classes_is_thing=is_thing_v, top_k_instances=64),
            'panoptic': PanopticTaskHelper(
                semantic_n_classes=n_classes + 1,
                semantic_classes_is_thing=is_thing_v),
            'scene': SceneTaskHelper(n_classes=10)})
    states = {n: h.empty_metric_states()
              for n, h in jpipe.task_helpers.items()}
    with jax.default_matmul_precision('highest'):
        step = jpipe.make_fused_eval_step(
            {pre.APPLIED_PREPROCESSING_KEY:
             jbatch[pre.APPLIED_PREPROCESSING_KEY]}, output_keys=RAW_KEYS)
        raw, losses, want = step(v['params'], v['batch_stats'],
                                 j_strip(jbatch), states)
    raw, losses, want = jax.tree_util.tree_map(np.asarray,
                                               (raw, losses, want))

    # the port's metric updates on the JAX step's raw outputs
    heat, offset, ori = raw['instance_output']
    predictions = {
        'semantic': (_nchw(raw['semantic_output']), ()),
        'instance': ((_nchw(heat), _nchw(offset), _nchw(ori)), ()),
        'scene': (torch.from_numpy(np.array(raw['scene_output'])), ())}
    _, got_losses, got = tpipe.evaluate_outputs(
        predictions, dict(batch, **static), tpipe.empty_metric_states())
    _assert_states_match(got, want)
    # the fixture's GT segments are counted (random weights match none)
    assert float(got['panoptic']['pq']['fn_per_class'].sum()) > 0
    assert set(got_losses) == set(losses)
    for k, w in losses.items():
        np.testing.assert_allclose(float(got_losses[k]), w, rtol=1e-4,
                                   err_msg=k)

    # the port's own step end to end
    _, _, own = tpipe.make_fused_eval_step(static)(
        batch, tpipe.empty_metric_states())
    cm, want_cm = own['semantic'].numpy(), want['semantic']
    counted = int((host['semantic_fullres'] != 0).sum())
    assert cm.sum() == want_cm.sum() == counted
    assert np.abs(cm - want_cm).sum() / 2 <= 1e-3 * cm.sum()
    tpipe.load_metric_states(own)
    _, _, logs = tpipe.validation_epoch_end()
    assert {'semantic_miou', 'panoptic_all_deeplab_pq', 'scene_acc'} \
        <= set(logs)
    for k, val in logs.items():
        if k.endswith('num_categories'):
            continue
        if '_mae_' in k:
            assert math.isnan(val) or 0.0 <= val <= (
                180.0 if k.endswith('deg') else math.pi), (k, val)
        else:
            assert 0.0 <= val <= 1.0, (k, val)
