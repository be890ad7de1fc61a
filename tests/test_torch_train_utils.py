"""The training loop's host-side state machines in the PyTorch/CUDA port
against the JAX package, on the CPU: the loss weightings, the
checkpoint policy, the CSV log and the console printing; and the port's
examples/train_synthetic.py run as the JAX package's test runs its own
(tests/test_examples.py).

- Fixed, DWA and RLW over a scripted sequence of 3 epochs of losses (a
  repeated step included, as after a resume): the weights before every
  step and the reduced sums equal the JAX package's exactly; DWA's
  `state_dict` round-trips, and a weighting loaded from it goes on as
  the original.
- `CheckpointHelper` over scripted validation logs: the same decisions,
  the same 'ckpt_*' log entries, the same errors for an unknown or
  ambiguous shorthand and an unknown direction.
- `CSVLogger`: the file equals the JAX package's byte for byte on the
  same logs (numpy scalars, tensors / jax arrays, a key set that grows),
  also when a run resumes an existing file.
- `cprint*`: the same text as the JAX package's, without colour off a
  terminal.
- The helpers refuse `store_examples=True` (not ported)."""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nicr_mtsa_tpu.utils import CheckpointHelper as JHelper
from nicr_mtsa_tpu.utils import CSVLogger as JLogger
from nicr_mtsa_tpu.utils import _printing as jprint
from nicr_mtsa_tpu.weighting import (DynamicWeightAverage as JDWA,
                                     FixedLossWeighting as JFixed,
                                     RandomLossWeighting as JRLW)
from nicr_mtsa_tpu_torch.utils import CheckpointHelper, CSVLogger
from nicr_mtsa_tpu_torch.utils import _printing as tprint
from nicr_mtsa_tpu_torch.weighting import (DynamicWeightAverage,
                                           FixedLossWeighting,
                                           RandomLossWeighting)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ('semantic_total_loss', 'instance_center_total_loss',
        'scene_total_loss')


def _script():
    """(batch_idx, losses) of 3 epochs of 4 steps, the second step of
    epoch 1 repeated (a resumed step)."""
    rng = np.random.default_rng(0)
    steps = []
    for epoch in range(3):
        for b in range(4):
            losses = {k: float(rng.uniform(0.1, 3.0)) / (1 + epoch)
                      for k in KEYS}
            steps.append((b, losses))
            if (epoch, b) == (1, 1):
                steps.append((b, {k: v * 0.9 for k, v in losses.items()}))
    return steps


def _drive(weighting, steps, as_tensor):
    out = []
    for b, losses in steps:
        weights = dict(weighting.weights)
        given = {k: as_tensor(v) for k, v in losses.items()}
        out.append((weights, float(weighting.reduce_losses(given, b))))
    return out


WEIGHTINGS = {
    'fixed': (lambda: JFixed({KEYS[0]: 0.5, KEYS[2]: 2.0}),
              lambda: FixedLossWeighting({KEYS[0]: 0.5, KEYS[2]: 2.0})),
    'dwa': (lambda: JDWA(KEYS), lambda: DynamicWeightAverage(KEYS)),
    'dwa_t1': (lambda: JDWA(KEYS, temperature=1.0),
               lambda: DynamicWeightAverage(KEYS, temperature=1.0)),
    'rlw': (lambda: JRLW(KEYS, seed=3), lambda: RandomLossWeighting(
        KEYS, seed=3)),
    'rlw_scaled': (lambda: JRLW(KEYS, temperature=2.0, scale=True, seed=4),
                   lambda: RandomLossWeighting(KEYS, temperature=2.0,
                                               scale=True, seed=4)),
}


@pytest.mark.parametrize('name', sorted(WEIGHTINGS))
def test_weighting_matches_jax(name):
    make_j, make_t = WEIGHTINGS[name]
    steps = _script()
    want = _drive(make_j(), steps, lambda v: jnp.asarray(v, jnp.float32))
    got = _drive(make_t(), steps, lambda v: torch.tensor(v))
    assert [w for w, _ in got] == [w for w, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-6)
    if name.startswith('dwa'):
        # weights of 1 until the first step of the third epoch has
        # closed the second: 4 + 5 + 1 steps
        assert all(set(w.values()) == {1.0} for w, _ in got[:10])
        assert all(set(w.values()) != {1.0} for w, _ in got[10:])
        np.testing.assert_allclose(sum(got[-1][0].values()), len(KEYS))


def test_dwa_state_dict_round_trips():
    steps = _script()
    a = DynamicWeightAverage(KEYS)
    _drive(a, steps[:7], float)
    state = a.state_dict()
    b = DynamicWeightAverage(KEYS)
    b.load_state_dict(state)
    assert b.state_dict() == state
    j = JDWA(KEYS)
    _drive(j, steps[:7], float)
    assert j.state_dict() == state
    assert _drive(b, steps[7:], float) == _drive(a, steps[7:], float)


def _ckpt_script():
    return [{'valid_semantic_miou': 0.2, 'valid_panoptic_all_deeplab_pq': 0.1,
             'valid_orientation_mae_gt_deg': 50.0, 'epoch': 0},
            {'valid_semantic_miou': 0.3, 'valid_panoptic_all_deeplab_pq': 0.05,
             'valid_orientation_mae_gt_deg': 40.0, 'epoch': 1},
            {'valid_semantic_miou': 0.25, 'valid_panoptic_all_deeplab_pq': 0.2,
             'valid_orientation_mae_gt_deg': 45.0, 'epoch': 2}]


@pytest.mark.parametrize('names', [
    ('valid_semantic_miou', 'panoptic_all_deeplab_pq'),
    ('semantic_miou+panoptic_all_deeplab_pq', 'mae_gt_deg'), None])
def test_checkpoint_helper_matches_jax(names):
    j, t = JHelper(names, debug=False), CheckpointHelper(names, debug=False)
    assert t.metric_mapping == j.metric_mapping
    for logs in _ckpt_script():
        jl, tl = dict(logs), dict(logs)
        assert t.check_for_checkpoint(tl) == j.check_for_checkpoint(jl)
        assert tl == jl
    assert t.metric_mapping == j.metric_mapping
    assert t.metric_mapping_joined == j.metric_mapping_joined


@pytest.mark.parametrize('names,error', [
    (('bacc',), 'No suitable metric'), (('miou',), 'Multiple suitable'),
    (('epoch',), 'No suitable metric')])
def test_checkpoint_helper_errors_match_jax(names, error):
    logs = dict(_ckpt_script()[0], valid_panoptic_semantic_miou=0.1,
                valid_epoch=1)
    for helper in (JHelper(names, debug=False),
                   CheckpointHelper(names, debug=False)):
        with pytest.raises(ValueError, match=error if names != ('epoch',)
                           else 'Cannot determine'):
            helper.check_for_checkpoint(dict(logs))


def _csv_rows(as_array):
    return [{'epoch': 0, 'train_total_loss': 7.25,
             'valid_semantic_miou': as_array(np.float32(0.125)),
             'valid_scene_acc': np.float32(0.5), 'note': 'a,b'},
            {'epoch': 1, 'train_total_loss': 6.5,
             'valid_semantic_miou': as_array(np.float32(0.3)),
             'valid_scene_acc': np.float32(0.25),
             'ckpt_valid_semantic_miou': 0.3}]


def test_csv_logger_file_matches_jax(tmp_path):
    for sub, logger, as_array in (
            ('jax', JLogger, jnp.asarray),
            ('port', CSVLogger, lambda a: torch.tensor(a))):
        d = tmp_path / sub
        d.mkdir()
        log = logger(str(d / 'log.csv'))
        rows = _csv_rows(as_array)
        log.log(rows[0])
        log.write()
        # a resumed run appends to the file it finds
        log = logger(str(d / 'log.csv'), write_interval=2)
        log.log(rows[1])
        log.write()
    want = (tmp_path / 'jax' / 'log.csv').read_bytes()
    assert (tmp_path / 'port' / 'log.csv').read_bytes() == want
    assert want.count(b'\n') == 3


def test_printing_matches_jax():
    for fn in ('cprint', 'cprint_section', 'cprint_step'):
        outs = []
        for mod in (jprint, tprint):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                getattr(mod, fn)('epoch', 1, color='green', attrs=('bold',))
            outs.append(buf.getvalue())
        assert outs[0] == outs[1] and '\033' not in outs[1], fn


def test_train_synthetic_example(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='2')
    res = subprocess.run(
        [sys.executable, '-m', 'nicr_mtsa_tpu_torch.examples.train_synthetic',
         '--cpu', '--epochs', '1', '--steps', '2', '--batch-size', '2',
         '--size', '64', '96', '--out', str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1].startswith('done; log at')
    assert (tmp_path / 'log.csv').exists()
    header = (tmp_path / 'log.csv').read_text().splitlines()[0].split(',')
    assert {'valid_semantic_miou', 'valid_panoptic_all_deeplab_pq',
            'valid_orientation_mae_gt_deg', 'train_total_loss'} <= set(header)
    assert (tmp_path / 'ckpt_epoch0.pt').exists()


def test_helpers_refuse_store_examples():
    """The validation examples (visualization) are not ported: asking
    for them raises instead of silently storing none."""
    from nicr_mtsa_tpu_torch.tasks import (InstanceTaskHelper,
                                           PanopticTaskHelper,
                                           SemanticTaskHelper)
    is_thing = (False, True, False)
    for make in (lambda: SemanticTaskHelper(2, store_examples=True),
                 lambda: InstanceTaskHelper(3, is_thing,
                                            store_examples=True),
                 lambda: PanopticTaskHelper(3, is_thing,
                                            store_examples=True)):
        with pytest.raises(NotImplementedError, match='store_examples'):
            make()
