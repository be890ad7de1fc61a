"""Set-up shared by the EMSANet training-step tests
(test_torch_emsanet_train_step.py, test_torch_emsanet_train_step_f64.py):
`bench.py --quick`'s wiring of `emsanet-bench` (resnet18 BasicBlock
encoders with SE-add fusion, PPM context 128, dense decoders (64, 48,
32) with one NonBottleneck1D block each, learned-3x3-zeropad
upsampling, the semantic upsampling in the head) at 64 x 96, B=4, on
the random batch of `bench.py --train` (seed 0).

One set of variables steps both packages: the flax tree of a training
init (shaped by `jax.eval_shape`, the decoders' side heads included),
filled from the port's seeded init with the norms' statistics and
scales randomised and the orientation bias away from 0. The decoders'
channel dropout is off on both sides: flax's `Dropout` is the identity
while the JAX step is traced (a patch scoped to the step) and the
port's rates are 0. The JAX gradients come from the optimizer chain's
first link, which keeps what it is given."""
import dataclasses

import flax.linen
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from nicr_mtsa_tpu.models.multi_task import (
    MultiTaskModelConfig as JConfig, build_model as jax_build,
)
from nicr_mtsa_tpu.pipeline import (MultiTaskPipeline as JaxPipeline,
                                    default_postprocessors as jax_post)
from nicr_mtsa_tpu.tasks import (InstanceTaskHelper, SceneTaskHelper,
                                 SemanticTaskHelper)
from nicr_mtsa_tpu_torch.models.common import Dropout
from nicr_mtsa_tpu_torch.models.multi_task import DTYPES
from nicr_mtsa_tpu_torch.models.multi_task import build_model as torch_build
from nicr_mtsa_tpu_torch.ops import cuda as kernels
from nicr_mtsa_tpu_torch.optim import AdamW
from nicr_mtsa_tpu_torch.pipeline import (
    MultiTaskPipeline, default_postprocessors, emsanet_train_config,
    train_task_helpers,
)
from nicr_mtsa_tpu_torch.testing import build_train_batch, train_arrays
from nicr_mtsa_tpu_torch.utils import flax_weights as fw
from _torch_train_helpers import np_tree, randomise_norms

H, W, B = 64, 96, 4
TASKS = ('semantic', 'instance', 'orientation', 'scene', 'panoptic')
IS_THING = tuple(i < 8 for i in range(40))
# bench.py:558-584 with --quick
QUICK = dict(backbone_rgb='resnet18', backbone_depth='resnet18',
             resnet_block='basicblock', context_n_channels=128,
             decoder_n_channels=(64, 48, 32), decoder_n_blocks=1)
SIDE = ('semantic_decoder.side_head', 'instance_decoder.side_head')


def jax_pipeline(dtype=jnp.float32, remat: bool = False):
    """`remat`: `bench.py --remat` (backbone and decoder remat)."""
    cfg = JConfig(
        tasks=('semantic', 'instance', 'orientation', 'scene'),
        input_size=(H, W), semantic_n_classes=40, scene_n_classes=10,
        upsampling='learned-3x3-zeropad',
        prediction_upsampling='learned-3x3-zeropad',
        defer_semantic_prediction_upsampling=False, dtype=dtype,
        backbone_remat=remat, decoder_remat=remat, **QUICK)
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    return JaxPipeline(
        jax_build(cfg),
        jax_post(tasks=TASKS, semantic_classes_is_thing=IS_THING,
                 top_k_instances=64),
        {'semantic': SemanticTaskHelper(n_classes=40),
         'instance': InstanceTaskHelper(
             semantic_n_classes=41,
             semantic_classes_is_thing=(False,) + IS_THING,
             top_k_instances=64),
         'scene': SceneTaskHelper(n_classes=10)},
        optimizer=optax.chain(capture, optax.adamw(1e-4)))


def port_model(train: bool = True, remat: bool = False):
    """The port's model (f32 parameters), dropout rates 0; `remat`:
    `emsanet_train_config(remat=True)`."""
    cfg = dataclasses.replace(
        emsanet_train_config((H, W), 'float32', remat=remat), **QUICK)
    model = torch_build(cfg, device='cpu', train=train)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def jax_batch(dtype=jnp.float32):
    return {k: jnp.asarray(a, dtype) if a.dtype == np.float32
            else jnp.asarray(a)
            for k, a in train_arrays(B, H, W, seed=0, rgbd=False).items()}


class _NoDropout:
    """flax `nn.Dropout(...)` as the identity."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


def template():
    """The flax tree of the JAX package's training init, shapes only."""
    jp = jax_pipeline()
    return jax.eval_shape(lambda: jp.model.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        jp.model_inputs(jax_batch()), train=True))


def variables(tmpl):
    v = fw.torch_to_flax_variables(port_model(), tmpl)
    randomise_norms(v, np.random.default_rng(3))
    # orientation vectors well away from 0: unit_length's gradient grows
    # as 1 / |x| and would amplify rounding at near-zero raw vectors
    v['params']['instance_decoder']['task_head']['conv_orientation'][
        'bias'] = np.array([1.0, -0.5], np.float32)
    return v


def jax_step(v, dtype=jnp.float32, remat: bool = False):
    """One JAX training step from variables `v`, computing in `dtype`
    (float64 under `jax.enable_x64`), with `remat` as `jax_pipeline`.
    Returns (losses, gradients, new params, new batch stats), the trees
    as numpy under the port's names."""
    with jax.enable_x64(dtype == jnp.float64):
        jp = jax_pipeline(dtype, remat)
        cast = lambda t: jax.tree_util.tree_map(   # noqa: E731
            lambda a: jnp.asarray(a, dtype), t)
        params = cast(v['params'])
        state = {'params': params, 'batch_stats': cast(v['batch_stats']),
                 'opt_state': jp.optimizer.init(params),
                 'step': jnp.zeros((), jnp.int32)}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen, 'Dropout', _NoDropout)
            with jax.default_matmul_precision('highest'):
                new_state, losses = jp.train_step(
                    state, jax_batch(dtype), rng=jax.random.PRNGKey(1))
        npd = np.float64 if dtype == jnp.float64 else np.float32
        return ({k: float(x) for k, x in losses.items()},
                fw.flax_tree_to_torch(np_tree(new_state['opt_state'][0],
                                              npd)),
                fw.flax_tree_to_torch(np_tree(new_state['params'], npd)),
                fw.flax_tree_to_torch(np_tree(new_state['batch_stats'], npd),
                                      'batch_stats'))


def port_step(v, dtype: str = 'float32', remat: bool = False):
    """One step of the port from variables `v` on the same batch,
    computing in `dtype` ('float64': parameters and statistics in f64
    too), with `remat` as `port_model`. Returns (losses, train state,
    kernel launches of the step); the gradients stay in `.grad`."""
    model = port_model(remat=remat)
    fw.load_flax_variables(model, v)
    if dtype == 'float64':
        model.double()
    pipe = MultiTaskPipeline(
        model, default_postprocessors(TASKS, IS_THING, top_k_instances=64),
        train_task_helpers(), optimizer=AdamW(1e-4),
        compute_dtype=DTYPES[dtype])
    state = pipe.create_train_state()
    kernels.reset_launch_counts()
    state, losses = pipe.train_step(
        state, build_train_batch(B, H, W, seed=0, device='cpu', rgbd=False),
        torch.Generator())
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    return {k: float(x) for k, x in losses.items()}, state, launches
