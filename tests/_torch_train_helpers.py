"""Set-up shared by the training-step tests (test_torch_train_step.py,
test_torch_train_step_f64.py): a small `emsaformer_dve_v2`-shaped model
(multimodal SwinV2, embed 32, depths (2, 2, 2, 1), 8 x 8 windows;
narrow MLP decoders, the embedding head included) at 256 x 256 (no
stage pads: see test_torch_train_model.py for the JAX package's NaN
gradient at a pad), B=4, drop rates 0 on both sides (flax `clone` of
the unbound modules); one set of variables, made from the port's seeded
init with the norms' statistics and scales randomised, steps both
packages. The JAX gradients are taken from the optimizer chain's first
link, which keeps what it is given."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from nicr_mtsa_tpu.configs import emsaformer_dve_v2
from nicr_mtsa_tpu.models.backbones.swin import SwinBackbone
from nicr_mtsa_tpu.models.multi_task import build_model as jax_build
from nicr_mtsa_tpu.pipeline import (MultiTaskPipeline as JaxPipeline,
                                    default_postprocessors as jax_post)
from nicr_mtsa_tpu.tasks import (InstanceTaskHelper, SceneTaskHelper,
                                 SemanticTaskHelper)
from nicr_mtsa_tpu_torch.models.backbones.swin import (
    SwinBackbone as TSwinBackbone,
)
from nicr_mtsa_tpu_torch.models.multi_task import DTYPES
from nicr_mtsa_tpu_torch.models.multi_task import build_model as torch_build
from nicr_mtsa_tpu_torch.optim import AdamW
from nicr_mtsa_tpu_torch.pipeline import (
    MultiTaskPipeline, default_postprocessors, emsaformer_train_config,
    train_task_helpers,
)
from nicr_mtsa_tpu_torch.testing import build_train_batch, train_arrays
from nicr_mtsa_tpu_torch.utils import flax_weights as fw

H = W = 256
B = 4                 # the PPM's 1 x 1 bin: BatchNorm over B values
TASKS = ('semantic', 'instance', 'orientation', 'scene', 'panoptic')
IS_THING = tuple(i < 8 for i in range(40))
SMALL = dict(embedding_dim=8, context_n_channels=64,
             decoder_n_channels=(32, 16, 16, 16))
BACKBONE = dict(embed_dim=32, depths=(2, 2, 2, 1), n_heads=(1, 2, 4, 8),
                window_size=8, v2=True, n_input_channels=4, multimodal=True,
                embed_dim_depth=16, stochastic_depth=0.0)


def randomise_norms(tree, rng):
    """Running statistics and norm scales off their init values; the
    biases stay as initialised: a random LayerNorm bias dominates the
    pooled features, and a BatchNorm over a few such values (the PPM's
    bins) is ill-conditioned in f32 (its variance is a difference of
    nearly equal numbers)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            randomise_norms(v, rng)
        elif k == 'mean':
            tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k in ('var', 'scale'):
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)


def np_tree(tree, dtype=np.float32):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype), tree)


def jax_pipeline(dtype=jnp.float32, backend='pallas-interpret'):
    """The JAX package's training pipeline of the small model, computing
    in `dtype` with the Swin attention on `backend`."""
    cfg = dataclasses.replace(
        emsaformer_dve_v2(input_size=(H, W), dtype=dtype), **SMALL,
        backbone_attn_backend=backend)
    m = jax_build(cfg)
    backbone = SwinBackbone(attn_backend=backend, dtype=dtype, **BACKBONE)
    m = m.clone(encoder=m.encoder.clone(backbone=backbone),
                context_module=m.context_module.clone(
                    n_channels_in=backbone.stages_n_channels[-1]),
                **{d: getattr(m, d).clone(dropout_p=0.0) for d in (
                    'semantic_decoder', 'instance_decoder',
                    'embedding_decoder')})
    is_thing_v = (False,) + IS_THING
    # the first link keeps the gradients it is given as its state
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    return JaxPipeline(
        m, jax_post(tasks=TASKS, semantic_classes_is_thing=IS_THING,
                    top_k_instances=64),
        {'semantic': SemanticTaskHelper(n_classes=40),
         'instance': InstanceTaskHelper(
             semantic_n_classes=41, semantic_classes_is_thing=is_thing_v,
             top_k_instances=64),
         'scene': SceneTaskHelper(n_classes=10)},
        optimizer=optax.chain(capture, optax.adamw(1e-4)))


def port_model(dtype: str = 'float32'):
    """The port's small model in training mode (f32 parameters)."""
    cfg = emsaformer_train_config((H, W), dtype, stochastic_depth=0.0,
                                  decoder_dropout=0.0, **SMALL)
    return torch_build(cfg, device='cpu', rgbd_backbone=TSwinBackbone(
        generator=torch.Generator().manual_seed(0), **BACKBONE)).train()


def variables():
    """Flax variables of the small model: shaped by tracing the JAX init
    only, values from the port's seeded init with the norms' statistics
    and scales randomised, the orientation bias away from 0."""
    jp = jax_pipeline()
    jbatch = {k: jnp.asarray(v) for k, v in train_arrays(B, H, W,
                                                         seed=0).items()}
    template = jax.eval_shape(lambda: jp.model.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        jp.model_inputs(jbatch), train=True))
    v = fw.torch_to_flax_variables(port_model(), template)
    randomise_norms(v, np.random.default_rng(3))
    # orientation vectors well away from 0: unit_length's gradient grows
    # as 1 / |x| and would amplify rounding at near-zero raw vectors
    v['params']['instance_decoder']['task_head']['conv_orientation'][
        'bias'] = np.array([1.0, -0.5], np.float32)
    return v


def jax_step(v, dtype=jnp.float32, backend='pallas-interpret'):
    """One JAX training step from variables `v` on the bench batch (seed
    0), computing in `dtype` (float64 under `jax.enable_x64`). Returns
    (losses, gradients, new params, new batch stats), the trees as
    numpy under the port's names."""
    arrays = train_arrays(B, H, W, seed=0)
    with jax.enable_x64(dtype == jnp.float64):
        jp = jax_pipeline(dtype, backend)
        cast = lambda t: jax.tree_util.tree_map(   # noqa: E731
            lambda a: jnp.asarray(a, dtype), t)
        params = cast(v['params'])
        state = {'params': params, 'batch_stats': cast(v['batch_stats']),
                 'opt_state': jp.optimizer.init(params),
                 'step': jnp.zeros((), jnp.int32)}
        batch = {k: jnp.asarray(a, dtype) if a.dtype == np.float32
                 else jnp.asarray(a) for k, a in arrays.items()}
        with jax.default_matmul_precision('highest'):
            new_state, losses = jp.train_step(state, batch,
                                              rng=jax.random.PRNGKey(1))
        npd = np.float64 if dtype == jnp.float64 else np.float32
        return ({k: float(x) for k, x in losses.items()},
                fw.flax_tree_to_torch(np_tree(new_state['opt_state'][0],
                                              npd)),
                fw.flax_tree_to_torch(np_tree(new_state['params'], npd)),
                fw.flax_tree_to_torch(np_tree(new_state['batch_stats'], npd),
                                      'batch_stats'))


def port_step(v, dtype: str = 'float32'):
    """One step of the port from variables `v` on the same batch,
    computing in `dtype` ('float64': parameters and statistics in f64
    too). Returns (losses, train state); gradients stay in `.grad`."""
    model = port_model(dtype)
    fw.load_flax_variables(model, v)
    if dtype == 'float64':
        model.double()
    pipe = MultiTaskPipeline(
        model, default_postprocessors(TASKS, IS_THING, top_k_instances=64),
        train_task_helpers(), optimizer=AdamW(1e-4),
        compute_dtype=DTYPES[dtype])
    state = pipe.create_train_state()
    state, losses = pipe.train_step(
        state, build_train_batch(B, H, W, seed=0, device='cpu'),
        torch.Generator())
    return {k: float(x) for k, x in losses.items()}, state


def grad(p):
    return torch.zeros_like(p) if p.grad is None else p.grad


def left_out_of_f32_reference(name: str) -> bool:
    """Leaves where the JAX package's f32 step through the Pallas VJP
    is no reference (test_torch_train_step_f64.py holds them to a
    float64 step instead)."""
    return name.startswith(('encoder.backbone.patch_embed.',
                            'encoder.backbone.layer1_')) or name.endswith(
        ('attn.cpb_fc1.weight', 'attn.cpb_fc1.bias', 'attn.logit_scale'))


def noise_floor(grads) -> float:
    """|gradient| below which a leaf holds rounding noise only."""
    return 1e-5 * max(float(np.abs(g).max()) for g in grads.values())
