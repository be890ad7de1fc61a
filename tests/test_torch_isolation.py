"""Isolation of the PyTorch/CUDA port (nicr_mtsa_tpu_torch): it and
chip_smoke.py import neither JAX (jax, flax, optax) nor the JAX
package; its CUDA kernel wrappers never fall back to the plain version
for a CUDA tensor; chip_smoke.py fails without a card or without the
rest of the repo."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / 'nicr_mtsa_tpu_torch'
FORBIDDEN = ('jax', 'flax', 'optax', 'jaxlib', 'nicr_mtsa_tpu')


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + '.') for f in FORBIDDEN)


def _sources():
    return sorted(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py']


def test_import_pulls_in_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import nicr_mtsa_tpu_torch as p\n'
        'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = [n for n in sys.modules if n in ("jax", "flax", "optax")\n'
        '       or n == "nicr_mtsa_tpu" or n.startswith("nicr_mtsa_tpu.")\n'
        '       or n.startswith(("jax.", "flax.", "optax."))]\n'
        'print(len([n for n in sys.modules\n'
        '           if n.startswith("nicr_mtsa_tpu_torch")]))\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 25      # every submodule imported


SWIN_SLICE_MODULES = (
    'nicr_mtsa_tpu_torch.configs',
    'nicr_mtsa_tpu_torch.models.backbones.swin',
    'nicr_mtsa_tpu_torch.models.decoders.embedding',
    'nicr_mtsa_tpu_torch.ops.cuda.layernorm',
    'nicr_mtsa_tpu_torch.ops.cuda.window_attention',
    'nicr_mtsa_tpu_torch.postprocessing.dense_visual_embedding',
    'nicr_mtsa_tpu_torch.tasks.dense_visual_embedding',
)


def test_swin_slice_modules_import_with_jax_blocked():
    """The Swin slice's modules import with jax, flax and the JAX
    package made unimportable."""
    code = (
        'import sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        '        if name.split(".")[0] in ("jax", "flax", "optax", '
        '"jaxlib", "nicr_mtsa_tpu"):\n'
        '            raise ImportError("blocked: " + name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import importlib\n'
        f'for m in {SWIN_SLICE_MODULES!r}:\n'
        '    importlib.import_module(m)\n'
        'from nicr_mtsa_tpu_torch.pipeline import emsaformer_bench_config\n'
        'print(emsaformer_bench_config().backbone_rgbd)\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == 'swin-multi-t-v2-128'


@pytest.mark.parametrize('path', _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f'{path.name}:{node.lineno} imports {bad}'


def _no_library(monkeypatch, tmp_path, module):
    """Pretend CPU tensors are CUDA tensors and that no kernel library
    is built and nvcc is absent."""
    from nicr_mtsa_tpu_torch.ops.cuda import _build
    monkeypatch.setattr(module, 'is_cuda_tensor', lambda t: True)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(_build, '_LIBS', {})
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'no-cuda'))
    monkeypatch.setattr(shutil, 'which', lambda name: None)


def test_finisher_raises_without_library(monkeypatch, tmp_path):
    from nicr_mtsa_tpu_torch.ops.cuda import finisher4x as fin
    _no_library(monkeypatch, tmp_path, fin)
    x = torch.zeros(1, 3, 2, 2)
    k = torch.zeros(3, 1, 3, 3)
    before = fin.upsample4x_argmax_score.launches
    with pytest.raises(RuntimeError, match='nvcc'):
        fin.upsample4x_argmax_score(x, k, None, k, None)
    assert fin.upsample4x_argmax_score.launches == before


def test_grouping_raises_without_library(monkeypatch, tmp_path):
    from nicr_mtsa_tpu_torch.ops.cuda import grouping as grp
    _no_library(monkeypatch, tmp_path, grp)
    before = grp.group_pixels_kernel.launches
    with pytest.raises(RuntimeError, match='nvcc'):
        grp.group_pixels_kernel(
            torch.zeros(1, 8), torch.zeros(1, 8), torch.zeros(1, 2, 2),
            torch.ones(1, 2, dtype=torch.bool),
            torch.ones(1, 8, dtype=torch.bool))
    assert grp.group_pixels_kernel.launches == before


def test_semantic_reduce_raises_without_library(monkeypatch, tmp_path):
    from nicr_mtsa_tpu_torch.ops.cuda import semantic_reduce as sr
    _no_library(monkeypatch, tmp_path, sr)
    before = sr.semantic_argmax_score.launches
    with pytest.raises(RuntimeError, match='nvcc'):
        sr.semantic_argmax_score(torch.zeros(1, 3, 2, 2))
    assert sr.semantic_argmax_score.launches == before


def test_resize_reduce_raises_without_library(monkeypatch, tmp_path):
    from nicr_mtsa_tpu_torch.ops.cuda import resize_reduce as rr
    _no_library(monkeypatch, tmp_path, rr)
    before = rr.crop_resize_argmax_score.launches
    with pytest.raises(RuntimeError, match='nvcc'):
        rr.crop_resize_argmax_score(torch.zeros(1, 3, 4, 4),
                                    (slice(0, 4), slice(0, 4)), 8, 8)
    assert rr.crop_resize_argmax_score.launches == before


def test_intersection_raises_without_library(monkeypatch, tmp_path):
    from nicr_mtsa_tpu_torch.ops.cuda import intersection as it
    _no_library(monkeypatch, tmp_path, it)
    before = it.intersection_matrix_kernel.launches
    with pytest.raises(RuntimeError, match='nvcc'):
        it.intersection_matrix_kernel(torch.zeros(1, 8, dtype=torch.int32),
                                      torch.zeros(1, 8, dtype=torch.int32),
                                      4, 4)
    assert it.intersection_matrix_kernel.launches == before


def test_layernorm_raises_without_library(monkeypatch, tmp_path):
    from nicr_mtsa_tpu_torch.ops.cuda import layernorm as ln
    _no_library(monkeypatch, tmp_path, ln)
    before = ln.fused_layer_norm.launches
    with pytest.raises(RuntimeError, match='nvcc'):
        ln.fused_layer_norm(torch.zeros(4, 8), torch.ones(8), torch.zeros(8))
    assert ln.fused_layer_norm.launches == before


def test_window_attention_raises_without_library(monkeypatch, tmp_path):
    from nicr_mtsa_tpu_torch.ops.cuda import window_attention as wa
    _no_library(monkeypatch, tmp_path, wa)
    before = wa.window_attention_block.launches
    with pytest.raises(RuntimeError, match='nvcc'):
        wa.window_attention_block(
            torch.zeros(2, 64, 32), torch.zeros(32, 96), torch.zeros(96),
            torch.zeros(32, 32), torch.zeros(32), torch.zeros(1, 64, 64), 1)
    assert wa.window_attention_block.launches == before


def test_finisher_bilinear_raises_without_library(monkeypatch, tmp_path):
    from nicr_mtsa_tpu_torch.ops.cuda import finisher4x as fin
    _no_library(monkeypatch, tmp_path, fin)
    before = (fin.upsample4x_bilinear_argmax_score.launches,
              fin.upsample4x_argmax_score.launches)
    with pytest.raises(RuntimeError, match='nvcc'):
        fin.upsample4x_bilinear_argmax_score(torch.zeros(1, 3, 2, 2))
    assert (fin.upsample4x_bilinear_argmax_score.launches,
            fin.upsample4x_argmax_score.launches) == before


_VARIANT_CALLS = {
    'finisher2x': ('finisher2x', 'upsample2x_argmax_score',
                   lambda f: f(torch.zeros(1, 3, 2, 2),
                               torch.zeros(3, 1, 3, 3), None)),
    'window_attention_qkv': ('window_attention_qkv', 'window_attention_qkv',
                             lambda f: f(torch.zeros(2, 64, 96),
                                         torch.zeros(1, 64, 64), 1)),
}


@pytest.mark.parametrize('kernel', sorted(_VARIANT_CALLS))
def test_serve_variant_kernel_raises_without_library(monkeypatch, tmp_path,
                                                     kernel):
    """The serving variants' kernels (the 2x finisher, attention over the
    packed qkv): a CUDA tensor without a library raises, no launch is
    counted."""
    import importlib
    module, name, call = _VARIANT_CALLS[kernel]
    mod = importlib.import_module(f'nicr_mtsa_tpu_torch.ops.cuda.{module}')
    _no_library(monkeypatch, tmp_path, mod)
    fn = getattr(mod, name)
    before = fn.launches
    with pytest.raises(RuntimeError, match='nvcc'):
        call(fn)
    assert fn.launches == before


def _run_chip_smoke(cwd):
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    env['CUDA_VISIBLE_DEVICES'] = ''
    return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_card():
    res = _run_chip_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    res = _run_chip_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


TRAIN_SLICE_MODULES = (
    'nicr_mtsa_tpu_torch.optim',
    'nicr_mtsa_tpu_torch.ops.cuda.window_attention_core',
    'nicr_mtsa_tpu_torch.pipeline',
    'nicr_mtsa_tpu_torch.testing',
    'nicr_mtsa_tpu_torch.utils.dtypes',
    'nicr_mtsa_tpu_torch.utils.flax_weights',
)


def test_train_slice_modules_import_with_jax_blocked():
    """The training slice's modules import with jax, flax, optax and
    the JAX package made unimportable."""
    code = (
        'import sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        '        if name.split(".")[0] in ("jax", "flax", "optax", '
        '"jaxlib", "nicr_mtsa_tpu"):\n'
        '            raise ImportError("blocked: " + name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import importlib\n'
        f'for m in {TRAIN_SLICE_MODULES!r}:\n'
        '    importlib.import_module(m)\n'
        'from nicr_mtsa_tpu_torch import build_train_pipeline\n'
        'from nicr_mtsa_tpu_torch.pipeline import emsaformer_train_config\n'
        'print(emsaformer_train_config().defer_semantic_prediction_'
        'upsampling)\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == 'False'


# the modules of the remat / presets slice (activation recompute, the
# six bench.py presets and --quick)
REMAT_SLICE_MODULES = (
    'nicr_mtsa_tpu_torch.configs',
    'nicr_mtsa_tpu_torch.models.remat',
    'nicr_mtsa_tpu_torch.models.blocks',
    'nicr_mtsa_tpu_torch.models.backbones',
    'nicr_mtsa_tpu_torch.models.decoders.base',
    'nicr_mtsa_tpu_torch.pipeline',
)


def test_remat_slice_modules_import_with_jax_blocked():
    """The remat and presets slice's modules import, and build a remat
    config of every preset, with jax, flax, optax and the JAX package
    made unimportable."""
    code = (
        'import sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        '        if name.split(".")[0] in ("jax", "flax", "optax", '
        '"jaxlib", "nicr_mtsa_tpu"):\n'
        '            raise ImportError("blocked: " + name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import importlib\n'
        f'for m in {REMAT_SLICE_MODULES!r}:\n'
        '    importlib.import_module(m)\n'
        'from nicr_mtsa_tpu_torch.configs import BENCH_CONFIGS\n'
        'from nicr_mtsa_tpu_torch.pipeline import emsanet_bench_config\n'
        'print(len(BENCH_CONFIGS), emsanet_bench_config(quick=True, '
        'remat=True).decoder_remat)\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == '6 True'


def _core_args(requires_grad=False):
    q = torch.zeros(2, 64, 32, requires_grad=requires_grad)
    return q, torch.zeros(2, 64, 32), torch.zeros(2, 64, 32), \
        torch.zeros(1, 64, 64)


_CORE_CALLS = {
    'forward': lambda wac, rg: wac.window_attention_core_forward(
        *_core_args(rg)),
    'backward': lambda wac, rg: wac.window_attention_core_backward(
        *_core_args(rg), torch.zeros(2, 64, 32), torch.zeros(2, 1, 64)),
    'dbias': lambda wac, rg: wac.dbias_reduce(
        torch.zeros(3, 1, 64, 64, requires_grad=rg)),
}
_CORE_COUNTERS = {'forward': 'window_attention_core_forward',
                  'backward': 'window_attention_core_backward',
                  'dbias': 'dbias_reduce'}


@pytest.mark.parametrize('entry', sorted(_CORE_CALLS))
def test_window_attention_core_raises_without_library(monkeypatch, tmp_path,
                                                      entry):
    from nicr_mtsa_tpu_torch.ops.cuda import window_attention_core as wac
    _no_library(monkeypatch, tmp_path, wac)
    counter = getattr(wac, _CORE_COUNTERS[entry])
    before = counter.launches
    with pytest.raises(RuntimeError, match='nvcc'):
        _CORE_CALLS[entry](wac, False)
    assert counter.launches == before


def _grad_calls():
    """(module name, wrapper name, call with an input that requires
    grad) of every ctypes kernel wrapper."""
    x = lambda *s: torch.zeros(*s, requires_grad=True)
    k = torch.zeros(3, 1, 3, 3)
    return {
        'finisher4x': ('finisher4x', 'upsample4x_argmax_score',
                       lambda f: f(x(1, 3, 2, 2), k, None, k, None)),
        'finisher4x_bilinear': ('finisher4x',
                                'upsample4x_bilinear_argmax_score',
                                lambda f: f(x(1, 3, 2, 2))),
        'grouping': ('grouping', 'group_pixels_kernel',
                     lambda f: f(x(1, 8), torch.zeros(1, 8),
                                 torch.zeros(1, 2, 2),
                                 torch.ones(1, 2, dtype=torch.bool),
                                 torch.ones(1, 8, dtype=torch.bool))),
        'semantic_reduce': ('semantic_reduce', 'semantic_argmax_score',
                            lambda f: f(x(1, 3, 2, 2))),
        'resize_reduce': ('resize_reduce', 'crop_resize_argmax_score',
                          lambda f: f(x(1, 3, 4, 4),
                                      (slice(0, 4), slice(0, 4)), 8, 8)),
        # slot maps are integers: a float map stands for a graph input
        'intersection': ('intersection', 'intersection_matrix_kernel',
                         lambda f: f(x(1, 8), torch.zeros(1, 8), 4, 4)),
        'layernorm': ('layernorm', 'fused_layer_norm',
                      lambda f: f(x(4, 8), torch.ones(8), torch.zeros(8))),
        'window_attention_block': (
            'window_attention', 'window_attention_block',
            lambda f: f(torch.zeros(2, 64, 32), x(32, 96), torch.zeros(96),
                        torch.zeros(32, 32), torch.zeros(32),
                        torch.zeros(1, 64, 64), 1)),
        'window_attention_image': (
            'window_attention', 'window_attention_image',
            lambda f: f(x(1, 8, 8, 32), torch.zeros(32, 96),
                        torch.zeros(96), torch.zeros(32, 32),
                        torch.zeros(32), torch.zeros(1, 64, 64), 1, 8)),
        'window_attention_core_fwd': (
            'window_attention_core', 'window_attention_core_forward',
            lambda f: f(*_core_args(True))),
        'window_attention_core_dbias': (
            'window_attention_core', 'dbias_reduce',
            lambda f: f(x(3, 1, 64, 64))),
        'finisher2x': ('finisher2x', 'upsample2x_argmax_score',
                       lambda f: f(x(1, 3, 2, 2), k, None)),
        'window_attention_qkv': (
            'window_attention_qkv', 'window_attention_qkv',
            lambda f: f(x(2, 64, 96), torch.zeros(1, 64, 64), 1)),
    }


@pytest.mark.parametrize('kernel', sorted(_grad_calls()))
def test_kernel_wrappers_refuse_gradients(monkeypatch, tmp_path, kernel):
    """A CUDA kernel's output has no grad_fn: with grad mode on and an
    input that requires grad, every wrapper raises before it builds or
    launches anything (no silently lost gradients); under no_grad it
    goes on to the launch (here: no library, so nvcc is missing)."""
    import importlib
    module, name, call = _grad_calls()[kernel]
    mod = importlib.import_module(f'nicr_mtsa_tpu_torch.ops.cuda.{module}')
    _no_library(monkeypatch, tmp_path, mod)
    fn = getattr(mod, name)
    counter = (mod.window_attention_block if name == 'window_attention_image'
               else fn)
    before = counter.launches
    with pytest.raises(RuntimeError, match='no gradient'):
        call(fn)
    with torch.no_grad(), pytest.raises(RuntimeError, match='nvcc'):
        call(fn)
    assert counter.launches == before


@pytest.mark.parametrize('phase', ['check_window_attention_core',
                                   'train_swin', 'train_card_vs_cpu',
                                   'train_emsanet',
                                   'emsanet_train_card_vs_cpu'])
def test_chip_smoke_training_phases_fail_without_card(phase):
    """The training phases of chip_smoke.py raise on a machine without
    a card: none of them falls back to the CPU."""
    import argparse
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        cs = importlib.import_module('chip_smoke')
    finally:
        sys.path.remove(str(ROOT))
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    from nicr_mtsa_tpu_torch.ops.cuda import window_attention_core as wac
    from nicr_mtsa_tpu_torch.pipeline import emsanet_train_config
    args = argparse.Namespace(train_steps=1, profile=False)
    calls = {
        'check_window_attention_core': lambda: cs.check_window_attention_core(
            wac, {}),
        'train_swin': lambda: cs.train(args, kernels, 'no card', {},
                                       'train_swin'),
        'train_card_vs_cpu': lambda: cs.train_card_vs_cpu({}, (64, 96)),
        'train_emsanet': lambda: cs.train(
            args, kernels, 'no card', {}, 'train_emsanet',
            emsanet_train_config((64, 96)),
            dict.fromkeys(kernels.KERNELS, cs.EMSANET_TRAIN_LAUNCHES)),
        'emsanet_train_card_vs_cpu': lambda: cs.train_card_vs_cpu(
            {}, (64, 96), cfg=emsanet_train_config((64, 96), 'float32'),
            faults=cs.EMSANET_TRAIN_FAULTS,
            key='emsanet_train_card_vs_cpu'),
    }
    with pytest.raises(RuntimeError):
        calls[phase]()


@pytest.mark.parametrize('phase', ['eval_swin', 'swin_eval_card_vs_cpu'])
def test_chip_smoke_swin_eval_phases_fail_without_card(phase):
    """The Swin eval phases of chip_smoke.py raise on a machine without
    a card: neither falls back to the CPU."""
    import argparse
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        cs = importlib.import_module('chip_smoke')
    finally:
        sys.path.remove(str(ROOT))
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    args = argparse.Namespace(swin_steps=1, profile=False)
    calls = {'eval_swin': lambda: cs.evaluate_swin(args, kernels, 'no card',
                                                   {}),
             'swin_eval_card_vs_cpu': lambda: cs.swin_eval_card_vs_cpu({})}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[phase]()


DATA_SLICE_MODULES = (
    'nicr_mtsa_tpu_torch.native',
    'nicr_mtsa_tpu_torch.data',
    'nicr_mtsa_tpu_torch.data.png',
    'nicr_mtsa_tpu_torch.data.dataset',
    'nicr_mtsa_tpu_torch.data.loader',
    'nicr_mtsa_tpu_torch.data.feeder',
    'nicr_mtsa_tpu_torch.data.preprocessing',
)


def test_data_path_runs_with_jax_and_pil_blocked():
    """The host data path's modules import, and read and preprocess a
    fixture sample, with jax, flax, the JAX package and PIL made
    unimportable."""
    code = (
        'import sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        '        if name.split(".")[0] in ("jax", "flax", "optax", '
        '"jaxlib", "nicr_mtsa_tpu", "PIL"):\n'
        '            raise ImportError("blocked: " + name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import importlib\n'
        f'for m in {DATA_SLICE_MODULES!r}:\n'
        '    importlib.import_module(m)\n'
        'from nicr_mtsa_tpu_torch.data import get_dataset, preprocessing '
        'as p\n'
        'ds = get_dataset("tests/fixtures/mini_dataset", split="valid")\n'
        's = p.Compose([p.Resize(48, 64), p.NormalizeRGB()])(ds[0])\n'
        'print(s["rgb"].shape, s["depth"].dtype)\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == '(48, 64, 3) uint16'


@pytest.mark.parametrize('fault', ['source_missing', 'compiler_fails'])
def test_native_library_raises_without_fallback(monkeypatch, tmp_path,
                                                fault):
    """No build, no library: every entry point raises (the JAX package's
    wrapper returns None there and drops to numpy)."""
    import numpy as np
    from nicr_mtsa_tpu_torch import native
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    if fault == 'source_missing':
        monkeypatch.setattr(native, 'SOURCE', tmp_path / 'missing.cpp')
        match = 'source missing'
    else:
        monkeypatch.setattr(shutil, 'which', lambda name: '/bin/false')
        match = 'failed'
    img = np.zeros((4, 6, 3), np.uint8)
    calls = (lambda: native.nearest_resize(img, 2, 3),
             lambda: native.bilinear_resize_u8(img, 2, 3),
             lambda: native.normalize_u8(img, [0, 0, 0], [1, 1, 1]),
             lambda: native.hsv_jitter_u8(img, 1, 1, 1))
    for call in calls:
        with pytest.raises(RuntimeError, match=match):
            call()
    assert native._LIB is None and not list(tmp_path.glob('build/*.so'))


@pytest.mark.parametrize('phase', ['eval_dataset', 'eval_dataset_card_vs_cpu',
                                   'serve_stream'])
def test_chip_smoke_data_path_phases_fail_without_card(phase):
    """The data-path phases of chip_smoke.py raise on a machine without
    a card: none falls back to the CPU."""
    import argparse
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        cs = importlib.import_module('chip_smoke')
    finally:
        sys.path.remove(str(ROOT))
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    args = argparse.Namespace(steps=1, requests=1, profile=False)
    calls = {'eval_dataset': lambda: cs.evaluate_dataset(args, kernels,
                                                         'no card', {}),
             'eval_dataset_card_vs_cpu': lambda: cs.eval_dataset_card_vs_cpu(
                 {}),
             'serve_stream': lambda: cs.serve_stream(
                 args, kernels, 'no card', {'serving': {
                     'frames_per_s': 1.0}})}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[phase]()


@pytest.mark.parametrize('phase', ['latency', 'serve_bench', 'stream_bench',
                                   'eval_bench', 'train_bench'])
def test_chip_smoke_bench_size_phases_fail_without_card(phase):
    """The phases at the bench's batch sizes (latency, serving, eval,
    training with and without remat) raise on a machine without a
    card: none falls back to the CPU."""
    import argparse
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        cs = importlib.import_module('chip_smoke')
    finally:
        sys.path.remove(str(ROOT))
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    from nicr_mtsa_tpu_torch.pipeline import emsanet_bench_config
    args = argparse.Namespace(requests=1, train_steps=1, profile=False)
    calls = {
        'latency': lambda: cs.latency('no card', {}),
        'serve_bench': lambda: cs.serve_exact(
            emsanet_bench_config(quick=True), 1, cs.QUICK_KERNELS, kernels,
            'no card', {}, 'serve_bench', B=cs.BENCH_SERVE_B['emsanet']),
        'stream_bench': lambda: cs.serve_stream(
            args, kernels, 'no card', {}, 'stream_bench',
            B=cs.BENCH_STREAM_B, n_requests=1, checks=False),
        'eval_bench': lambda: cs.eval_bench(kernels, 'no card', {}),
        'train_bench': lambda: cs.train_bench(args, kernels, 'no card', {},
                                              'emsanet'),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[phase]()


# the modules of the training loop's slice (augmentation, the synthetic
# dataset, loss weighting, eager validation, checkpoints, the policy and
# the log, the example)
LOOP_SLICE_MODULES = (
    'nicr_mtsa_tpu_torch.data.preprocessing.augmentation',
    'nicr_mtsa_tpu_torch.testing.dataset',
    'nicr_mtsa_tpu_torch.testing.preprocessing',
    'nicr_mtsa_tpu_torch.weighting',
    'nicr_mtsa_tpu_torch.parallel',
    'nicr_mtsa_tpu_torch.parallel.checkpoint',
    'nicr_mtsa_tpu_torch.metrics.mae',
    'nicr_mtsa_tpu_torch.utils.checkpointing',
    'nicr_mtsa_tpu_torch.utils.csv_logger',
    'nicr_mtsa_tpu_torch.utils._printing',
    'nicr_mtsa_tpu_torch.examples.train_synthetic',
)


def test_loop_slice_runs_with_jax_blocked(tmp_path):
    """The training loop's modules import, augment a synthetic sample,
    step DWA and write and read back a checkpoint with jax, flax, optax
    and the JAX package made unimportable."""
    code = (
        'import sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        '        if name.split(".")[0] in ("jax", "flax", "optax", '
        '"jaxlib", "nicr_mtsa_tpu"):\n'
        '            raise ImportError("blocked: " + name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import importlib\n'
        f'for m in {LOOP_SLICE_MODULES!r}:\n'
        '    importlib.import_module(m)\n'
        'import numpy as np, torch\n'
        'from nicr_mtsa_tpu_torch.data import preprocessing as p\n'
        'from nicr_mtsa_tpu_torch.testing import get_dataset\n'
        'from nicr_mtsa_tpu_torch.weighting import DynamicWeightAverage\n'
        'from nicr_mtsa_tpu_torch.parallel import (load_checkpoint, '
        'save_checkpoint)\n'
        'ds = get_dataset(p.Compose([p.RandomHorizontalFlip(0.5), '
        'p.RandomHSVJitter(0.1, 0.1, 0.1)]), n_samples=1, height=24, '
        'width=32)\n'
        's = ds.load(0, np.random.RandomState(0))\n'
        'w = DynamicWeightAverage(("a",))\n'
        'w.reduce_losses({"a": 1.0}, 0)\n'
        't = torch.zeros(3)\n'
        'state = {"params": {"w": t}, "batch_stats": {}, "opt_state": '
        'type("S", (), {"count": torch.zeros((), dtype=torch.int32), '
        '"mu": {"w": t}, "nu": {"w": t}})(), "step": torch.zeros(())}\n'
        f'path = save_checkpoint({str(tmp_path / "c")!r}, state, '
        'extra={"dwa": w.state_dict()})\n'
        '_, extra = load_checkpoint(path)\n'
        'print(s["rgb"].shape, extra["dwa"]["loss_buffer"])\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "(24, 32, 3) [{'a': 1.0}]"


def test_chip_smoke_train_loop_phase_fails_without_card():
    """Phase 32 (the training loop) raises on a machine without a card,
    before it writes its dataset: it does not fall back to the CPU."""
    import argparse
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        cs = importlib.import_module('chip_smoke')
    finally:
        sys.path.remove(str(ROOT))
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    args = argparse.Namespace(profile=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cs.train_loop(args, kernels, 'no card', {})


def test_train_synthetic_example_refuses_without_card(monkeypatch):
    """The port's example runs on the card unless `--cpu`: without a
    card it raises instead of drifting to the CPU."""
    from nicr_mtsa_tpu_torch.examples import train_synthetic
    monkeypatch.setattr(sys, 'argv', ['train_synthetic', '--steps', '1'])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_synthetic.main()


# the modules of the dense model surface (surface normals, the ResNet
# variants, the context modules, the upsamplings, `ln`, the dense
# embedding decoder)
SURFACE_SLICE_MODULES = (
    'nicr_mtsa_tpu_torch.metrics.rmse',
    'nicr_mtsa_tpu_torch.models.blocks',
    'nicr_mtsa_tpu_torch.models.backbones.resnet',
    'nicr_mtsa_tpu_torch.models.context',
    'nicr_mtsa_tpu_torch.models.upsampling',
    'nicr_mtsa_tpu_torch.models.decoders.embedding',
    'nicr_mtsa_tpu_torch.models.decoders.normal',
    'nicr_mtsa_tpu_torch.models.decoders.panoptic',
    'nicr_mtsa_tpu_torch.postprocessing.normal',
    'nicr_mtsa_tpu_torch.tasks.normal',
    'nicr_mtsa_tpu_torch.testing.batch',
)


def test_surface_slice_modules_import_with_jax_blocked():
    """The surface slice's modules import, and a small model with every
    new option serves normals on the CPU, with jax, flax, optax and the
    JAX package made unimportable."""
    code = (
        'import sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        '        if name.split(".")[0] in ("jax", "flax", "optax", '
        '"jaxlib", "nicr_mtsa_tpu"):\n'
        '            raise ImportError("blocked: " + name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import importlib\n'
        f'for m in {SURFACE_SLICE_MODULES!r}:\n'
        '    importlib.import_module(m)\n'
        'import numpy as np\n'
        'from nicr_mtsa_tpu_torch.models.multi_task import '
        'MultiTaskModelConfig\n'
        'from nicr_mtsa_tpu_torch.pipeline import build_serving_pipeline\n'
        'cfg = MultiTaskModelConfig(tasks=("semantic", "instance", '
        '"normal"), backbone_rgb="resnet18se", backbone_depth="resnet18se",'
        ' resnet_block="basicblock", context_module="appm", '
        'context_n_channels=32, decoder_n_channels=(16, 16, 16), '
        'decoder_n_blocks=1, input_size=(64, 96), normalization="ln", '
        'upsampling="learned-3x3", prediction_upsampling="nearest")\n'
        'pipe = build_serving_pipeline(cfg, device="cpu", '
        'extra_output_tasks=("normal",))\n'
        'out = pipe(np.zeros((1, 64, 96, 3), np.uint8), '
        'np.ones((1, 64, 96), np.uint16))\n'
        'print(tuple(out["normal_output"].shape))\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == '(1, 3, 64, 96)'


@pytest.mark.parametrize('phase', ['normals', 'model_surface'])
def test_chip_smoke_surface_phases_fail_without_card(phase):
    """Phases 33 (normals) and 34 (the model surface) raise on a
    machine without a card: neither falls back to the CPU."""
    import argparse
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        cs = importlib.import_module('chip_smoke')
    finally:
        sys.path.remove(str(ROOT))
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    args = argparse.Namespace(requests=1, steps=1, train_steps=1,
                              profile=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(cs, phase)(args, kernels, 'no card', {})


@pytest.mark.parametrize('defer', [True, 'all'])
@pytest.mark.parametrize('mode', ['learned-3x3', 'nearest'])
def test_deferred_head_refuses_other_upsamplings(mode, defer):
    """Only a learned-3x3-zeropad head (or, deferring both, a bilinear
    one) can be deferred: a learned-3x3 or nearest head raises, as the
    JAX package asserts; so does a post-op under deferral."""
    from nicr_mtsa_tpu_torch.models.decoders import TaskHead
    with pytest.raises(ValueError, match='defer'):
        TaskHead(8, 40, upsampling=mode, n_upsamplings=2,
                 defer_last_upsampling=defer)
    with pytest.raises(ValueError, match='defer'):
        TaskHead(8, 3, upsampling='learned-3x3-zeropad', n_upsamplings=2,
                 defer_last_upsampling=defer, post='unit-length')


# the modules of the outputs slice: the dense panoptic scores and debug
# branches, example images, the rest of the host transforms, step
# checkpoints and the two examples
OUTPUTS_SLICE_MODULES = (
    'nicr_mtsa_tpu_torch.visualization',
    'nicr_mtsa_tpu_torch.data.preprocessing.semantic',
    'nicr_mtsa_tpu_torch.data.preprocessing.transform_wrapper',
    'nicr_mtsa_tpu_torch.data.preprocessing.dense_visual_embedding',
    'nicr_mtsa_tpu_torch.parallel.checkpoint',
    'nicr_mtsa_tpu_torch.postprocessing.panoptic',
    'nicr_mtsa_tpu_torch.examples.infer_panoptic',
    'nicr_mtsa_tpu_torch.examples.eval_dataset',
)


def test_outputs_slice_modules_import_with_jax_blocked(tmp_path):
    """The outputs slice's modules import, and the serving example runs
    on the CPU and writes its images, with jax, flax, optax and the JAX
    package made unimportable."""
    code = (
        'import sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        '        if name.split(".")[0] in ("jax", "flax", "optax", '
        '"jaxlib", "nicr_mtsa_tpu"):\n'
        '            raise ImportError("blocked: " + name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import importlib\n'
        f'for m in {OUTPUTS_SLICE_MODULES!r}:\n'
        '    importlib.import_module(m)\n'
        'from nicr_mtsa_tpu_torch.examples import infer_panoptic\n'
        f'run = infer_panoptic.main(["--cpu", "--out", {str(tmp_path)!r}, '
        '"--size", "64", "96"])\n'
        'print(sorted(run["images"]))\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == \
        "['depth.png', 'panoptic.png', 'semantic.png']"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        'depth.png', 'panoptic.png', 'semantic.png']


@pytest.mark.parametrize('phase', ['eval_outputs', 'deferred_fullres',
                                   'dve_host'])
def test_chip_smoke_outputs_phases_fail_without_card(phase):
    """Phases 35-37 raise on a machine without a card: none falls back
    to the CPU."""
    import argparse
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        cs = importlib.import_module('chip_smoke')
    finally:
        sys.path.remove(str(ROOT))
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    args = argparse.Namespace(requests=1, steps=1, train_steps=1,
                              profile=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(cs, phase)(args, kernels, 'no card', {})


@pytest.mark.parametrize('example', ['infer_panoptic', 'eval_dataset'])
def test_examples_raise_without_card(example):
    """Without `--cpu` the examples run on the card, and raise where
    there is none."""
    import importlib
    module = importlib.import_module(
        f'nicr_mtsa_tpu_torch.examples.{example}')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        module.main(['--dataset', str(ROOT / 'tests' / 'fixtures' /
                                      'mini_dataset')]
                    if example == 'eval_dataset' else [])


# the modules of the pretrained slice: checkpoint surgery, pretrained
# backbones, the ImageNet classifier, the seeded torchvision-layout
# state dicts, the small utilities and the task registry
PRETRAINED_SLICE_MODULES = (
    'nicr_mtsa_tpu_torch.utils.torch_port',
    'nicr_mtsa_tpu_torch.utils.pretrained',
    'nicr_mtsa_tpu_torch.utils._misc',
    'nicr_mtsa_tpu_torch.utils._orientation',
    'nicr_mtsa_tpu_torch.models.backbones.pretraining',
    'nicr_mtsa_tpu_torch.testing.torchvision_state',
    'nicr_mtsa_tpu_torch.types',
    'nicr_mtsa_tpu_torch.multi_task',
)


def test_pretrained_slice_runs_with_jax_blocked(tmp_path):
    """The pretrained slice's modules import, and a ResNet-18 checkpoint
    on disk loads through `load_pretrained_backbone` (the path and
    $MTSA_PRETRAINED_DIR) and grafts into a small model, with jax,
    flax, optax and the JAX package made unimportable."""
    code = (
        'import os, sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        '        if name.split(".")[0] in ("jax", "flax", "optax", '
        '"jaxlib", "nicr_mtsa_tpu"):\n'
        '            raise ImportError("blocked: " + name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import importlib\n'
        f'for m in {PRETRAINED_SLICE_MODULES!r}:\n'
        '    importlib.import_module(m)\n'
        'import torch\n'
        'from nicr_mtsa_tpu_torch.models.multi_task import '
        'MultiTaskModelConfig, build_model\n'
        'from nicr_mtsa_tpu_torch.testing.torchvision_state import '
        'resnet_state_dict\n'
        'from nicr_mtsa_tpu_torch.utils.pretrained import '
        'load_pretrained_backbone, merge_backbone_variables\n'
        f'os.environ["MTSA_PRETRAINED_DIR"] = {str(tmp_path)!r}\n'
        'torch.save(resnet_state_dict(), os.path.join('
        'os.environ["MTSA_PRETRAINED_DIR"], "resnet18.pth"))\n'
        'rgb = load_pretrained_backbone("resnet18", 3)\n'
        'depth = load_pretrained_backbone("resnet18", 1, os.path.join('
        'os.environ["MTSA_PRETRAINED_DIR"], "resnet18.pth"))\n'
        'cfg = MultiTaskModelConfig(tasks=("semantic",), '
        'backbone_rgb="resnet18", backbone_depth="resnet18", '
        'resnet_block="basicblock", context_n_channels=32, '
        'decoder_n_channels=(16, 16, 16), decoder_n_blocks=1, '
        'input_size=(64, 96), semantic_n_classes=4)\n'
        'm = build_model(cfg, device="cpu")\n'
        'merge_backbone_variables(m, rgb, ("encoder", "backbone_rgb"))\n'
        'merge_backbone_variables(m, depth, ("encoder", "backbone_depth"))\n'
        'print(tuple(m.encoder.backbone_depth.conv1.weight.shape))\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == '(64, 1, 7, 7)'


@pytest.mark.parametrize('phase', ['pretrained', 'pretrained_swin',
                                   'train_normals_frames'])
def test_chip_smoke_pretrained_phases_fail_without_card(phase):
    """Phases 39-41 raise on a machine without a card: none falls back
    to the CPU."""
    import argparse
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        cs = importlib.import_module('chip_smoke')
    finally:
        sys.path.remove(str(ROOT))
    from nicr_mtsa_tpu_torch.ops import cuda as kernels
    args = argparse.Namespace(requests=1, steps=1, train_steps=1,
                              profile=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(cs, phase)(args, kernels, 'no card', {})
