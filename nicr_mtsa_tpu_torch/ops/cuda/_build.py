"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled at first use by `nvcc` into its own
shared library with a plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -fmad=false -Xptxas -v -o lib<name>-<hash>.so

The libraries land in `_build/` beside this file (listed in
.gitignore), named by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source or header is
rebuilt. `build_all` starts one nvcc per source at once. Nothing is
built or loaded when this module is imported."""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-fmad=false',
              '-Xptxas', '-v')

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def is_cuda_tensor(t) -> bool:
    """The wrappers' dispatch test: the plain version runs only for
    tensors on the CPU."""
    return t.device.type == 'cuda'


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would record through a kernel launch: the
    kernels' outputs carry no `grad_fn`, so the gradients of inputs that
    require grad would be lost without a word."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f'{what}: the CUDA kernel has no gradient, but '
                           f'an input requires grad; run it under '
                           f'torch.no_grad() or inference_mode()')


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                          'bin', 'nvcc'), shutil.which('nvcc')]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'cannot be built')


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f'{name}.cu'
    h = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.read_bytes())
    return src, BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def _start(name: str):
    src, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name}.cu:\n{log}')
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every csrc/*.cu in parallel (one nvcc each); seconds."""
    t0 = time.perf_counter()
    names = sorted(p.stem for p in CSRC.glob('*.cu'))
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')
