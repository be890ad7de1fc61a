"""Pretrained backbones, checkpoint surgery, the ImageNet classifier,
normal training samples and the small utilities of the PyTorch port
(nicr_mtsa_tpu_torch) against the JAX package on the CPU, f32.

- The torchvision-layout mapping (`utils/torch_port.py`) on seeded state
  dicts (nicr_mtsa_tpu_torch/testing/torchvision_state.py: ResNet basic
  and bottleneck, Swin v1 and v2, under the `model.` / `backbone.` /
  `_orig_mod.` prefixes, with heads and torchvision's buffers) equals
  the JAX `port_*_state_dict` carried through utils/flax_weights.py bit
  for bit, and fills the port's backbone exactly (names and shapes).
  Pure numpy: no JAX compile.
- The mapped weights drive the port's backbones as torchvision's
  modules compute (tests/test_torch_port.py's torchvision-style ResNet-18
  and Swin v1 / v2, whose patch merging concatenates the neighbours in
  torchvision's order): every stage within 1e-4.
- `adapt_first_conv` for 1, 3 and 4 channels, its ValueError for 2.
- `load_pretrained_backbone` from a path (a bare and a wrapped state
  dict) and from `$MTSA_PRETRAINED_DIR`; the RuntimeError (and the
  ValueError of a name without a torchvision source) with neither, in
  both packages. A '-v2' name loads the v1 layout in both (the JAX
  package strips the suffix): a v2 dict raises KeyError in both.
- `merge_backbone_variables` into a small RGB-D model: the grafted
  model's tensors equal the JAX graft's bit for bit, the depth stem is
  the summed kernel, every other tensor keeps its value, KeyError and
  ValueError in both; its forward within 1e-3 of the JAX model's (~20
  layers, as tests/test_torch_model_surface.py's whole-model tests).
- `ImageNetClassifier` on a pretrained ResNet-18: logits within rtol
  1e-4 / atol 1e-5 of the JAX module's, its variables carried by
  utils/flax_weights.py (backbone and `fc`).
- A sample with surface normals through the training preprocessing of
  examples/train_synthetic.py with normals (and a random crop) in both
  packages from the same generator state: bit-equal; the flip mirrors
  the map and keeps the sign of x; the collated batches equal and the
  normal helper's losses on them within rtol 1e-5.
- `partial_class`, the orientation conversions on random angles and
  `EnabledTasksInTheOrderTheyAppearInPredictions` against JAX.

Each JAX model is compiled once in the file (module-scoped fixtures)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_port_helpers as hp
from _torch_data_helpers import jax_native_loaded  # noqa: F401
from _torch_loop_helpers import _same, train_compose
from nicr_mtsa_tpu.utils import pretrained as jpre_bb
from nicr_mtsa_tpu.utils import torch_port as jtp
from nicr_mtsa_tpu_torch.testing.torchvision_state import (resnet_state_dict,
                                                           swin_state_dict)
from nicr_mtsa_tpu_torch.utils import flax_weights as fw
from nicr_mtsa_tpu_torch.utils import pretrained as tpre_bb
from nicr_mtsa_tpu_torch.utils import torch_port as ttp

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=1e-3)
PREFIXES = ('', 'model.', 'backbone.', '_orig_mod.')
SMALL_SWIN = dict(embed_dim=16, depths=(2, 2, 2, 2), n_heads=(2, 4, 8, 16))


def _state_of(module):
    out = dict(module.named_parameters())
    out.update(module.named_buffers())
    return out


def _port_backbone(kind):
    from nicr_mtsa_tpu_torch.models.backbones import (ResNetBackbone,
                                                      SwinBackbone)
    if kind.startswith('resnet'):
        bott = kind == 'resnet_bottleneck'
        return ResNetBackbone('bottleneck' if bott else 'basicblock',
                              (1, 2, 1, 1) if bott else (2, 2, 2, 2))
    v2 = kind == 'swin_v2'
    return SwinBackbone(window_size=8 if v2 else 7, v2=v2,
                        stochastic_depth=0.0, **SMALL_SWIN)


@pytest.mark.parametrize('kind', ['resnet_basic', 'resnet_bottleneck',
                                  'swin_v1', 'swin_v2'])
def test_mapping_matches_jax_and_fills_the_backbone(kind):
    bb = _port_backbone(kind)
    model = _state_of(bb)
    for i, prefix in enumerate(PREFIXES):
        if kind.startswith('resnet'):
            bott = kind == 'resnet_bottleneck'
            layers = (1, 2, 1, 1) if bott else (2, 2, 2, 2)
            sd = resnet_state_dict(layers, bott, seed=i, prefix=prefix)
            cases = [(n, jtp.port_resnet_state_dict(sd, layers, bott, n),
                      ttp.port_resnet_state_dict(sd, layers, bott, n))
                     for n in (1, 3, 4)]
        else:
            v2 = kind == 'swin_v2'
            sd = swin_state_dict(window_size=8 if v2 else 7, v2=v2, seed=i,
                                 prefix=prefix, **SMALL_SWIN)
            depths = SMALL_SWIN['depths']
            cases = [(3, jtp.port_swin_state_dict(sd, depths, v2),
                      ttp.port_swin_state_dict(sd, depths, v2))]
        for n, want, got in cases:
            want = fw.flax_to_torch_state(want)
            assert set(got) == set(want), set(got) ^ set(want)
            for k, v in got.items():
                assert v.dtype == torch.float32, k
                np.testing.assert_array_equal(v.numpy(), want[k],
                                              err_msg=f'{prefix}{k} ({n})')
            if n == 3:
                assert set(got) == set(model), set(got) ^ set(model)
                for k, v in got.items():
                    assert v.shape == model[k].shape, k


@pytest.mark.parametrize('kind', ['resnet18', 'swin_v1', 'swin_v2'])
def test_mapped_weights_compute_as_torchvision(kind):
    """The port's backbone with mapped weights against the torchvision-
    style modules of tests/test_torch_port.py: stage by stage; the
    Swin at a size with shifts and padding."""
    from nicr_mtsa_tpu_torch.models.backbones import (ResNetBackbone,
                                                      SwinBackbone)
    from test_torch_port import TorchResNet18, _TorchSwin
    torch.manual_seed(7)
    if kind == 'resnet18':
        ref = TorchResNet18().eval()
        bb = ResNetBackbone('basicblock', (2, 2, 2, 2))
        mapped = ttp.port_resnet_state_dict(ref.state_dict())
        x = np.random.default_rng(0).normal(size=(2, 3, 64, 96))
        tol = dict(rtol=1e-4, atol=1e-5)
    else:
        v2 = kind == 'swin_v2'
        depths, heads, embed, ws = (1, 2, 1, 1), (2, 4, 8, 16), 16, \
            8 if v2 else 7
        ref = _TorchSwin(embed=embed, heads=heads, ws=ws, depths=depths,
                         v2=v2).eval()
        bb = SwinBackbone(embed_dim=embed, depths=depths, n_heads=heads,
                          window_size=ws, v2=v2, stochastic_depth=0.0)
        mapped = ttp.port_swin_state_dict(ref.state_dict(), depths, v2)
        x = np.random.default_rng(0).normal(size=(2, 3, 112, 140))
        tol = dict(rtol=1e-4, atol=1e-4)
    tpre_bb.merge_backbone_variables(bb.eval(), mapped, path=())
    x = torch.from_numpy(x.astype(np.float32))
    with torch.no_grad():
        want = ref(x)
        y = x
        for i, w in enumerate(want):
            y = bb.forward_stage(i, y)
            got = y if kind == 'resnet18' else y.permute(0, 2, 3, 1)
            np.testing.assert_allclose(got.numpy(), w.numpy(), **tol,
                                       err_msg=f'stage {i}')


def test_adapt_first_conv_matches_jax():
    k = np.random.default_rng(0).normal(size=(8, 3, 7, 7)).astype(
        np.float32)
    for n in (1, 3, 4):
        want = jtp.adapt_first_conv(k, n)
        got = ttp.adapt_first_conv(torch.from_numpy(k), n)
        assert got.shape == (8, n, 7, 7)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ttp.adapt_first_conv(torch.from_numpy(k), 1)[:, 0].numpy(),
        k.sum(axis=1))
    for adapt, kernel in ((jtp.adapt_first_conv, k),
                          (ttp.adapt_first_conv, torch.from_numpy(k))):
        with pytest.raises(ValueError, match='3-channel conv to 2'):
            adapt(kernel, 2)


def _same_tree_as_port(jvars, tstate):
    want = fw.flax_to_torch_state(jvars)
    assert set(want) == set(tstate), set(want) ^ set(tstate)
    for k, v in tstate.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_load_pretrained_backbone_sources(tmp_path, monkeypatch):
    sd = resnet_state_dict((3, 4, 6, 3), seed=3, prefix='model.')
    bare, wrapped = tmp_path / 'bare.pth', tmp_path / 'wrapped.pth'
    torch.save(sd, str(bare))
    torch.save({'state_dict': sd, 'epoch': 3}, str(wrapped))
    env = tmp_path / 'pretrained'
    env.mkdir()
    torch.save(sd, str(env / 'resnet34.pth'))
    monkeypatch.delenv('MTSA_PRETRAINED_DIR', raising=False)
    for path in (bare, wrapped):
        for name, n in (('resnet34', 3), ('resnet34se', 1),
                        ('resnet34-d16', 4)):
            _same_tree_as_port(
                jpre_bb.load_pretrained_backbone(name, n, str(path)),
                tpre_bb.load_pretrained_backbone(name, n, str(path)))
    # no path and no directory: the JAX package asks torchvision, which
    # this machine cannot reach; the port reads local files only
    for load in (jpre_bb.load_pretrained_backbone,
                 tpre_bb.load_pretrained_backbone):
        with pytest.raises(RuntimeError, match='MTSA_PRETRAINED_DIR'):
            load('resnet34')
        with pytest.raises(ValueError, match="no torchvision weights"):
            load('resnet152')
    monkeypatch.setenv('MTSA_PRETRAINED_DIR', str(env))
    got = tpre_bb.load_pretrained_backbone('resnet34', 1)
    _same_tree_as_port(jpre_bb.load_pretrained_backbone('resnet34', 1), got)
    np.testing.assert_array_equal(got['conv1.weight'].numpy(),
                                  sd['model.conv1.weight'].sum(
                                      1, keepdim=True).numpy())
    # the path wins over the directory
    other = tmp_path / 'other.pth'
    torch.save(resnet_state_dict((3, 4, 6, 3), seed=4), str(other))
    assert not torch.equal(
        tpre_bb.load_pretrained_backbone('resnet34', 3, str(other))[
            'conv1.weight'], got['conv1.weight'])
    for load in (jpre_bb.load_pretrained_backbone,
                 tpre_bb.load_pretrained_backbone):
        with pytest.raises(ValueError, match='unknown pretrained'):
            load('mobilenet', 3, str(other))


def test_v2_name_loads_the_v1_layout_in_both(tmp_path):
    """The JAX package strips '-v2' and ports with v2=False: a v1 dict
    under a '-v2' name gives v1 tensors (which a v2 model has no room
    for), a v2 dict raises KeyError on the missing bias table. The port
    keeps that behaviour."""
    from nicr_mtsa_tpu_torch.models.backbones import SwinBackbone
    small = dict(embed_dim=8, depths=(2, 2, 6, 2), n_heads=(1, 2, 4, 8))
    v1, v2 = tmp_path / 'v1.pth', tmp_path / 'v2.pth'
    torch.save(swin_state_dict(seed=5, **small), str(v1))
    torch.save(swin_state_dict(window_size=8, v2=True, seed=6, **small),
               str(v2))
    got = tpre_bb.load_pretrained_backbone('swin-t-v2', 3, str(v1))
    _same_tree_as_port(
        jpre_bb.load_pretrained_backbone('swin-t-v2', 3, str(v1)), got)
    assert 'layer1_block0.attn.relative_position_bias_table' in got
    assert not any('logit_scale' in k for k in got)
    for load in (jpre_bb.load_pretrained_backbone,
                 tpre_bb.load_pretrained_backbone):
        with pytest.raises(KeyError, match='relative_position_bias_table'):
            load('swin-t-v2', 3, str(v2))
    with pytest.raises(KeyError, match='relative_position_bias_table'):
        tpre_bb.merge_backbone_variables(
            SwinBackbone(window_size=8, v2=True, **small), got, path=())


GRAFT_CONFIG = dict(
    tasks=('semantic',), backbone_rgb='resnet18', backbone_depth='resnet18',
    resnet_block='basicblock', context_n_channels=32,
    decoder_n_channels=(16, 16, 16), decoder_n_blocks=1,
    upsampling='bilinear', prediction_upsampling='bilinear',
    input_size=(64, 96), semantic_n_classes=4)


@pytest.fixture(scope='module')
def graft(tmp_path_factory):
    """The small RGB-D model in both packages on the same initial
    weights, a ResNet-18 checkpoint on disk and both grafts."""
    from nicr_mtsa_tpu.models.multi_task import (
        MultiTaskModelConfig as JConfig, build_model as jbuild)
    from nicr_mtsa_tpu_torch.models.multi_task import (
        MultiTaskModelConfig as TConfig, build_model as tbuild)
    path = tmp_path_factory.mktemp('ckpt') / 'resnet18.pth'
    torch.save(resnet_state_dict(seed=11, prefix='_orig_mod.'), str(path))
    jm = jbuild(JConfig(**GRAFT_CONFIG))
    tm = tbuild(TConfig(**GRAFT_CONFIG), device='cpu', seed=0).eval()
    x = {'rgb': jnp.zeros((1, 64, 96, 3)), 'depth': jnp.zeros((1, 64, 96, 1))}
    tmpl = jax.eval_shape(lambda: jm.init(
        {'params': jax.random.PRNGKey(0)}, x, train=False))
    jv = fw.torch_to_flax_variables(tm, tmpl)
    before = {k: v.clone() for k, v in _state_of(tm).items()}
    loads = {n: (jpre_bb.load_pretrained_backbone('resnet18', n, str(path)),
                 tpre_bb.load_pretrained_backbone('resnet18', n, str(path)))
             for n in (1, 3)}
    for n, where in ((3, 'backbone_rgb'), (1, 'backbone_depth')):
        jv = jpre_bb.merge_backbone_variables(jv, loads[n][0],
                                              path=('encoder', where))
        assert tpre_bb.merge_backbone_variables(
            tm, loads[n][1], path=('encoder', where)) is tm
    return dict(jm=jm, tm=tm, jv=jv, before=before, loads=loads, path=path)


def test_graft_matches_jax(graft):
    tm, jv, before, loads = (graft[k] for k in ('tm', 'jv', 'before',
                                                'loads'))
    after = _state_of(tm)
    _same_tree_as_port(jv, {k: v.detach() for k, v in after.items()})
    grafted = set()
    for n, where in ((3, 'backbone_rgb'), (1, 'backbone_depth')):
        for k, v in loads[n][1].items():
            name = f'encoder.{where}.{k}'
            assert torch.equal(after[name], v), name
            grafted.add(name)
    sd = torch.load(str(graft['path']), weights_only=True)
    assert torch.equal(after['encoder.backbone_depth.conv1.weight'],
                       sd['_orig_mod.conv1.weight'].sum(1, keepdim=True))
    assert after['encoder.backbone_depth.conv1.weight'].shape[1] == 1
    for k, v in before.items():
        if k not in grafted:
            assert torch.equal(after[k], v), k
    assert len(grafted) < len(before)
    # the refusals, in both packages, before anything is copied
    extra = dict(loads[3][1], **{'bogus.weight': torch.zeros(1)})
    with pytest.raises(KeyError, match='bogus'):
        tpre_bb.merge_backbone_variables(tm, extra)
    jextra = {'params': dict(loads[3][0]['params'], bogus={'x': 0})}
    with pytest.raises(KeyError, match='bogus'):
        jpre_bb.merge_backbone_variables(jv, jextra)
    wrong = dict(loads[3][1], **{'conv1.weight': torch.zeros(64, 3, 3, 3)})
    with pytest.raises(ValueError, match='conv1'):
        tpre_bb.merge_backbone_variables(tm, wrong)
    jwrong = {'params': dict(loads[3][0]['params'],
                             conv1={'kernel': np.zeros((3, 3, 3, 64))})}
    with pytest.raises(ValueError, match='conv1'):
        jpre_bb.merge_backbone_variables(jv, jwrong)
    assert all(torch.equal(after[k], v) for k, v in _state_of(tm).items())


def test_grafted_model_forward_matches_jax(graft):
    jm, tm, jv = graft['jm'], graft['tm'], graft['jv']
    rgb, depth = hp.inputs(seed=12)
    rgb, depth = rgb[:, :64, :96], depth[:, :64, :96]
    with jax.default_matmul_precision('highest'):
        want = jax.jit(lambda v, r, d: jm.apply(
            v, {'rgb': r, 'depth': d}, train=False))(jv, rgb, depth)
    with torch.no_grad():
        got = tm({'rgb': hp.to_nchw(rgb), 'depth': hp.to_nchw(depth)})
    np.testing.assert_allclose(hp.to_nhwc(got['semantic'][0]),
                               np.asarray(want['semantic'][0]), **TOL)


def test_imagenet_classifier_matches_jax(graft):
    """A ResNet-18 classifier grafted from the checkpoint in the port,
    its variables carried to the JAX module by flax_weights."""
    from nicr_mtsa_tpu.models.backbones.pretraining import (
        ImageNetClassifier as J)
    from nicr_mtsa_tpu.models.backbones.resnet import ResNetBackbone as JR
    from nicr_mtsa_tpu_torch.models.backbones import ResNetBackbone as TR
    from nicr_mtsa_tpu_torch.models.backbones.pretraining import (
        ImageNetClassifier as T)
    tm = T(TR('basicblock', (2, 2, 2, 2)), n_classes=10,
           generator=torch.Generator().manual_seed(2)).eval()
    tpre_bb.merge_backbone_variables(tm, graft['loads'][3][1],
                                     path=('backbone',))
    with torch.no_grad():
        tm.fc.bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(3))
    jm = J(backbone=JR(layers=(2, 2, 2, 2), block='basicblock'),
           n_classes=10)
    x = np.random.default_rng(13).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    tmpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)))
    jv = fw.torch_to_flax_variables(tm, tmpl)
    assert set(jv['params']) == {'backbone', 'fc'}
    assert jv['params']['fc']['kernel'].shape == (512, 10)
    with jax.default_matmul_precision('highest'):
        want = jax.jit(lambda v, a: jm.apply(v, a))(jv, x)
    with torch.no_grad():
        got = tm(hp.to_nchw(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def _normal_sample(get_dummy_sample):
    sample = get_dummy_sample()
    h, w = sample['rgb'].shape[:2]
    n = np.random.default_rng(14).normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:, :w // 8] = 0.0                 # an invalid band, zeros
    sample['normal'] = n
    return sample


def _normal_chain(p, train_chain):
    """The example's training chain with normals, a random crop after
    its resize."""
    t = list(train_chain.transforms)
    i = next(i for i, x in enumerate(t) if type(x).__name__ == 'Resize')
    t.insert(i + 1, p.RandomCrop(48, 80))
    return p.Compose(t)


def test_normal_training_samples_match_jax():
    from nicr_mtsa_tpu.data import mt_collate as jcollate
    from nicr_mtsa_tpu.data import preprocessing as jpre
    from nicr_mtsa_tpu.tasks import NormalTaskHelper as JHelper
    from nicr_mtsa_tpu.testing import get_dummy_sample as jdummy
    from nicr_mtsa_tpu_torch.data import move_batch_to_device, mt_collate
    from nicr_mtsa_tpu_torch.data import preprocessing as pre
    from nicr_mtsa_tpu_torch.examples.train_synthetic import (
        train_preprocessing)
    from nicr_mtsa_tpu_torch.tasks import NormalTaskHelper as THelper
    from nicr_mtsa_tpu_torch.testing import get_dummy_sample
    chain = _normal_chain(pre, train_preprocessing(64, 96, normals=True))
    jchain = _normal_chain(jpre, train_compose(jpre, 64, 96, normals=True))
    got, want, flips = [], [], set()
    for s in (0, 1, 2, 3):
        np.random.seed(s)
        want.append(jchain(_normal_sample(jdummy)))
        got.append(chain(_normal_sample(get_dummy_sample),
                         rng=np.random.RandomState(s)))
        _same(got[-1], want[-1])
        assert got[-1]['normal'].shape == (48, 80, 3)
        assert got[-1]['_down_8']['normal'].shape == (6, 10, 3)
        flips.add(next(m['was_flipped'] for m in got[-1][
            pre.APPLIED_PREPROCESSING_KEY] if 'was_flipped' in m))
    assert flips == {True, False}
    # the flip mirrors the map as an image and keeps the sign of x
    sample = _normal_sample(get_dummy_sample)
    flipped = pre.RandomHorizontalFlip(p=1.0)(
        dict(sample, normal=sample['normal'].copy()),
        rng=np.random.RandomState(0))['normal']
    np.testing.assert_array_equal(flipped, sample['normal'][:, ::-1])
    # collate, and the normal helper's losses on the batch
    jb, tb = jcollate(want), mt_collate(got)
    _same(tb, jb)
    tb = move_batch_to_device(tb, device='cpu')
    rng = np.random.default_rng(15)
    pred = rng.normal(size=(4, 48, 80, 3)).astype(np.float32)
    sides = tuple(rng.normal(size=(4, 48 // k, 80 // k, 3)).astype(
        np.float32) for k in (16, 8, 4))
    jl = JHelper().compute_losses(
        {k: jnp.asarray(v) if isinstance(v, np.ndarray) else
         {kk: jnp.asarray(vv) for kk, vv in v.items()
          if isinstance(vv, np.ndarray)} for k, v in jb.items()
         if k == 'normal' or k.startswith('_down_')},
        {'normal_output': jnp.asarray(pred),
         'normal_side_outputs': tuple(map(jnp.asarray, sides))})
    tl = THelper().compute_losses(
        tb, {'normal_output': hp.to_nchw(pred),
             'normal_side_outputs': tuple(map(hp.to_nchw, sides))})
    assert set(tl) == set(jl) and 'normal_loss_down_8' in tl
    for k, v in jl.items():
        np.testing.assert_allclose(float(tl[k]), float(v), rtol=1e-5,
                                   err_msg=k)


def test_small_utilities_match_jax():
    """`partial_class`, the orientation conversions on random angles
    (`unit_length` the task heads' own) and the task registry, against
    the JAX package."""
    _partial_class()
    _orientation()
    _task_registry()


def _partial_class():
    from nicr_mtsa_tpu.utils import partial_class as jpartial
    from nicr_mtsa_tpu_torch.utils import partial_class

    class Thing:
        """A configurable thing."""

        def __init__(self, a, b=2, c=3):
            self.args = (a, b, c)

    for make in (jpartial, partial_class):
        cls = make(Thing, b=5)
        assert cls is make(Thing, b=5)             # cached
        assert cls.__name__ == 'Thing' and cls.__doc__ == Thing.__doc__
        assert issubclass(cls, Thing)
        assert cls(1).args == (1, 5, 3) and cls(1, b=7, c=0).args == (1, 7, 0)
        arr = make(Thing, c=np.zeros(2))           # unhashable: uncached
        assert arr is not make(Thing, c=np.zeros(2))
        assert arr(4).args[:2] == (4, 2)
    assert partial_class(Thing, b=5)(1).args == jpartial(Thing, b=5)(1).args


def _orientation():
    from nicr_mtsa_tpu.utils import _orientation as J
    from nicr_mtsa_tpu_torch.models.decoders.heads import unit_length
    from nicr_mtsa_tpu_torch.utils import _orientation as T
    assert T.unit_length is unit_length
    rng = np.random.default_rng(16)
    rad = rng.uniform(-2 * np.pi, 2 * np.pi, size=(64,)).astype(np.float32)
    deg = rng.uniform(-720, 720, size=(64,)).astype(np.float32)
    bit = rng.normal(size=(64, 2)).astype(np.float32)
    for name, x in (('rad2deg', rad), ('deg2rad', deg),
                    ('rad2biternion', rad), ('biternion2rad', bit),
                    ('deg2biternion', deg), ('biternion2deg', bit)):
        got = getattr(T, name)(torch.from_numpy(x)).numpy()
        want = np.asarray(getattr(J, name)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5,
                                   err_msg=name)
    assert ((T.rad2deg(torch.from_numpy(rad)) >= 0)
            & (T.rad2deg(torch.from_numpy(rad)) < 360)).all()
    np.testing.assert_allclose(
        unit_length(torch.from_numpy(bit), dim=-1).numpy(),
        np.asarray(J.unit_length(jnp.asarray(bit))), rtol=1e-6, atol=1e-7)
    for name, x in (('np_rad2deg', rad), ('np_biternion2rad', bit)):
        np.testing.assert_array_equal(getattr(T, name)(x),
                                      getattr(J, name)(x), err_msg=name)
    for a in rad[:8]:
        got, want = T.np_rad2biternion(a), J.np_rad2biternion(a)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _task_registry():
    from nicr_mtsa_tpu import multi_task as J
    from nicr_mtsa_tpu_torch import multi_task as T
    from nicr_mtsa_tpu_torch.models import multi_task as models_mt
    assert T.KNOWN_TASKS == J.KNOWN_TASKS
    assert models_mt.KNOWN_TASKS is T.KNOWN_TASKS      # one definition
    for tasks in (('scene', 'semantic'), ('panoptic', 'normal', 'instance'),
                  J.KNOWN_TASKS[::-1], ()):
        got = T.EnabledTasksInTheOrderTheyAppearInPredictions(tasks)
        assert isinstance(got, tuple)
        assert got == J.EnabledTasksInTheOrderTheyAppearInPredictions(tasks)
    assert T.EnabledTasksInTheOrderTheyAppearInPredictions(
        ('scene', 'semantic')) == ('semantic', 'scene')
    for E in (T.EnabledTasksInTheOrderTheyAppearInPredictions,
              J.EnabledTasksInTheOrderTheyAppearInPredictions):
        with pytest.raises(ValueError, match="Unknown task: 'depth'"):
            E(('semantic', 'depth'))
