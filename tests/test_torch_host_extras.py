"""The rest of the host data transforms and the step checkpoints of the
PyTorch/CUDA port against the JAX package, on the CPU.

- `SemanticClassMapper` on the recorded fixture frames
  (tests/fixtures/mini_dataset) and their `_down_<k>` sub-samples: the
  remapped maps, the `mapped_pixels` stats and the provenance entry
  equal to the JAX package's, with and without stats.
- `five_crop`, `ten_crop` and `TransformWrapper` (a flip-and-transpose
  callable, a float scaling, both final crops) on a fixture frame with
  integer, float and boolean entries: every entry, its dtype and the
  leading crop axis equal.
- `DenseVisualEmbeddingTargetGenerator` on seeded synthetic embeddings
  (D=512, one a panoptic id, inserted out of id order): the LUT (in the
  dict's order) and the index image equal; a sample without embeddings
  passes through untouched, sub-samples included.
- `StepCheckpointManager`: the JAX fallback's retention sequence
  (tests/test_parallel.py's) keeps the same steps in both packages; a
  run saved at three steps with `max_to_keep=2` and resumed from the
  latest takes its next training step bit-equal to the run that saved
  it; an error of the background write is raised by the next call."""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nicr_mtsa_tpu.data import preprocessing as jpre
from nicr_mtsa_tpu.data.dataset import DirectoryRGBDDataset as JDataset
from nicr_mtsa_tpu.parallel.checkpoint import (
    StepCheckpointManager as JStepCheckpointManager)
from nicr_mtsa_tpu_torch.data import DirectoryRGBDDataset, mt_collate
from nicr_mtsa_tpu_torch.data import preprocessing as pre
from nicr_mtsa_tpu_torch.data.preprocessing import base as pre_base
from nicr_mtsa_tpu_torch.parallel import StepCheckpointManager
from nicr_mtsa_tpu_torch.parallel import checkpoint as ckpt_module
from _torch_data_helpers import FIXTURE
from test_torch_data_preprocessing import assert_same

torch.set_num_threads(2)


def _frames(split='valid'):
    """(port sample, JAX sample) pairs of the fixture, each read by its
    own package's dataset."""
    ds, jds = (DirectoryRGBDDataset(str(FIXTURE), split=split),
               JDataset(str(FIXTURE), split=split))
    return [(ds[i], jds[i]) for i in range(len(ds))]


def _with_downscales(sample, p):
    return p.MultiscaleSupervisionGenerator(
        downscales=(4, 8), keys=('semantic', 'instance'))(sample)


@pytest.mark.parametrize('disable_stats', [False, True])
def test_semantic_class_mapper_matches_jax(disable_stats):
    kwargs = dict(classes_to_map=(1, 4, 9), new_label=7,
                  disable_stats=disable_stats)
    mapped_any = False
    for sample, jsample in _frames():
        sample, jsample = (_with_downscales(sample, pre),
                           _with_downscales(jsample, jpre))
        before = sample['semantic'].copy()
        got = pre.SemanticClassMapper(**kwargs)(sample)
        want = jpre.SemanticClassMapper(**kwargs)(jsample)
        assert_same(got, want)
        mapped_any |= bool(np.isin(before, (1, 4, 9)).any())
        assert not np.isin(got['semantic'], (1, 4, 9)).any()
        assert not np.isin(got['_down_4']['semantic'], (1, 4, 9)).any()
        entry = got[pre.APPLIED_PREPROCESSING_KEY][-1]
        assert ('mapped_pixels' in entry) == (not disable_stats)
    assert mapped_any


def _wrapper_frame():
    sample, jsample = _frames()[0]
    for s in (sample, jsample):
        s['mask'] = s['semantic'] > 3
        s['weights'] = (s['depth'] / 7.0).astype(np.float32)
    return sample, jsample


def _flip_transpose(stack):
    return np.ascontiguousarray(stack[::-1].transpose(1, 0, 2))


def _scale(stack):
    return stack * np.float32(1.5)


@pytest.mark.parametrize('transform,final_crop', [
    (_flip_transpose, None), (_scale, ('five', 48, 64)),
    (_flip_transpose, ('ten', 60, 40))])
def test_transform_wrapper_matches_jax(transform, final_crop):
    sample, jsample = _wrapper_frame()
    got = pre.TransformWrapper(transform, final_crop=final_crop)(sample)
    want = jpre.TransformWrapper(transform, final_crop=final_crop)(jsample)
    assert_same(got, want)
    if final_crop is not None:
        n = {'five': 5, 'ten': 10}[final_crop[0]]
        assert got['semantic'].shape == (n,) + final_crop[1:]
        assert got['rgb'].shape == (n,) + final_crop[1:] + (3,)
        assert got['mask'].dtype == bool


def test_five_and_ten_crop_match_jax():
    stack = np.random.default_rng(0).normal(size=(37, 53, 4))
    for crop in ((20, 30), (37, 53), (1, 1)):
        np.testing.assert_array_equal(pre.five_crop(stack, *crop),
                                      jpre.five_crop(stack, *crop))
        np.testing.assert_array_equal(pre.ten_crop(stack, *crop),
                                      jpre.ten_crop(stack, *crop))
    with pytest.raises(ValueError):
        pre.five_crop(stack, 38, 10)


def _dve_sample(seed=0, D=512):
    rng = np.random.default_rng(seed)
    ids = np.array([131073, 7, 65536, 0, 196610, 65537])
    panoptic = rng.choice(np.append(ids, 999), size=(30, 40)).astype(
        np.int32)
    # inserted out of id order: the LUT follows the dict
    per_segment = {int(i): rng.normal(size=D).astype(np.float32)
                   for i in ids[[4, 0, 2, 1, 5]]}
    sample = {'panoptic': panoptic,
              'image_embedding': rng.normal(size=D).astype(np.float32),
              'panoptic_embedding': per_segment,
              '_down_2': {'panoptic': panoptic[::2, ::2].copy()},
              pre.APPLIED_PREPROCESSING_KEY:
                  pre_base.get_applied_preprocessing_meta({})}
    return sample


def test_dense_visual_embedding_targets_match_jax():
    for factor in (0.65, 0.0):
        sample, jsample = _dve_sample(), _dve_sample()
        got = pre.DenseVisualEmbeddingTargetGenerator(factor)(sample)
        want = jpre.DenseVisualEmbeddingTargetGenerator(factor)(jsample)
        assert_same(got, want)
        lut, idx = (got['dense_visual_embedding_lut'],
                    got['dense_visual_embedding_indices'])
        assert lut.shape == (5, 512) and lut.dtype == np.float32
        assert idx.dtype == np.int32
        np.testing.assert_allclose(np.linalg.norm(lut, axis=1), 1.0,
                                   rtol=1e-6)
        # row r + 1 of the index image is the dict's r-th id
        for r, seg_id in enumerate(got['panoptic_embedding']):
            assert (idx[got['panoptic'] == seg_id] == r + 1).all()
        assert (idx[~np.isin(got['panoptic'],
                             list(got['panoptic_embedding']))] == 0).all()
        # the sub-sample has no embeddings: untouched
        assert set(got['_down_2']) == {'panoptic'}
    plain = {k: v for k, v in _dve_sample().items()
             if k != 'image_embedding'}
    out = pre.DenseVisualEmbeddingTargetGenerator()(copy.deepcopy(plain))
    assert 'dense_visual_embedding_lut' not in out
    np.testing.assert_array_equal(out['panoptic'], plain['panoptic'])


def _kept_steps(directory):
    return {int(n.split('.')[0][5:]) for n in os.listdir(directory)
            if n.split('.')[0].startswith('step_')}


def _tiny_pipeline():
    from nicr_mtsa_tpu_torch.examples.train_synthetic import make_pipeline
    from nicr_mtsa_tpu_torch.models.common import Dropout
    from nicr_mtsa_tpu_torch.models.multi_task import (MultiTaskModelConfig,
                                                       build_model)
    cfg = MultiTaskModelConfig(
        tasks=('semantic', 'instance', 'orientation', 'scene'),
        backbone_rgb='resnet18', backbone_depth='resnet18',
        resnet_block='basicblock', context_n_channels=32,
        decoder_n_channels=(32, 24, 16), decoder_n_blocks=1,
        upsampling='bilinear', prediction_upsampling='bilinear',
        input_size=(64, 96), semantic_n_classes=10, scene_n_classes=5)
    model = build_model(cfg, device='cpu', seed=0, train=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return make_pipeline(model, cfg)


def _tiny_batch():
    from nicr_mtsa_tpu_torch.data import move_batch_to_device
    from nicr_mtsa_tpu_torch.examples.train_synthetic import (
        train_preprocessing)
    from nicr_mtsa_tpu_torch.pipeline import strip_non_arrays
    from nicr_mtsa_tpu_torch.testing import SyntheticRGBDDataset
    ds = SyntheticRGBDDataset(n_samples=2, height=128, width=192,
                              preprocessor=train_preprocessing(64, 96))
    host = mt_collate([ds.load(i, np.random.RandomState(i))
                       for i in range(2)])
    return strip_non_arrays(move_batch_to_device(host, device='cpu'))


def test_step_checkpoints_keep_the_jax_steps_and_resume_bit_equal(tmp_path):
    # the JAX fallback's retention sequence in both packages
    jmgr = JStepCheckpointManager(str(tmp_path / 'jax'), max_to_keep=2)
    jmgr._manager = None                  # the path without orbax
    mgr = StepCheckpointManager(str(tmp_path / 'port'), max_to_keep=2)
    pipe = _tiny_pipeline()
    state = pipe.create_train_state()
    for step in (1, 2, 3, 4):
        jmgr.save(step, {'w': jnp.ones((2,))}, extra={'epoch': step})
        mgr.save(step, state, extra={'epoch': step})
        mgr.wait_until_finished()
        assert _kept_steps(tmp_path / 'port') == _kept_steps(tmp_path / 'jax')
    assert _kept_steps(tmp_path / 'port') == {3, 4}
    assert mgr.latest_step() == jmgr.latest_step() == 4
    assert mgr.restore(target=pipe.create_train_state())[1] == {'epoch': 4}

    # three steps saved with max_to_keep=2, then resumed from the latest
    batch = _tiny_batch()
    mgr = StepCheckpointManager(str(tmp_path / 'run'), max_to_keep=2)
    for i in range(3):
        state, _ = pipe.train_step(state, batch,
                                   torch.Generator().manual_seed(i),
                                   batch_idx=i)
        mgr.save(int(state['step']), state,
                 extra={'epoch': i, 'dwa': pipe.loss_weighting.state_dict()})
    assert mgr.latest_step() == 3
    assert _kept_steps(tmp_path / 'run') == {2, 3}
    other = _tiny_pipeline()
    resumed, extra = mgr.restore(target=other.create_train_state())
    assert extra['epoch'] == 2 and int(resumed['step']) == 3
    other.loss_weighting.load_state_dict(extra['dwa'])
    state, la = pipe.train_step(state, batch, torch.Generator().manual_seed(9),
                                batch_idx=3)
    resumed, lb = other.train_step(resumed, batch,
                                   torch.Generator().manual_seed(9),
                                   batch_idx=3)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for group in ('params', 'batch_stats'):
        for n, t in state[group].items():
            assert torch.equal(t, resumed[group][n]), n
    for n, t in state['opt_state'].nu.items():
        assert torch.equal(t, resumed['opt_state'].nu[n]), n


def test_step_checkpoint_write_error_is_raised(tmp_path, monkeypatch):
    def broken(path, data):
        raise OSError('disk full')
    state = _tiny_pipeline().create_train_state()
    mgr = StepCheckpointManager(str(tmp_path), max_to_keep=2)
    monkeypatch.setattr(ckpt_module, '_write', broken)
    mgr.save(1, state)
    with pytest.raises(OSError, match='disk full'):
        mgr.wait_until_finished()
    mgr.wait_until_finished()                  # raised once
    mgr.save(2, state)
    with pytest.raises(OSError, match='disk full'):
        mgr.latest_step()
    monkeypatch.undo()
    mgr.save(3, state)
    assert mgr.latest_step() == 3
