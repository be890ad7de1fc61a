"""Shared helpers of the tests/test_torch_*.py files: one small
EMSANet-style configuration built in both packages, flax variables
(from a compiled JAX init, or shaped without one) with randomised
BatchNorm statistics and scales (so no norm is the identity), and
layout converters. Everything runs on the CPU in f32.

Config: resnet18 layout with nonbottleneck1d blocks, context 64,
decoders (64, 48, 32) with one block, 40 classes, 96 x 128 input."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

H, W = 96, 128
N_CLASSES = 40
N_THING = 8

CONFIG_KWARGS = dict(
    tasks=('semantic', 'instance', 'orientation', 'scene'),
    backbone_rgb='resnet18', backbone_depth='resnet18',
    resnet_block='nonbottleneck1d', context_n_channels=64,
    decoder_n_channels=(64, 48, 32), decoder_n_blocks=1,
    input_size=(H, W), semantic_n_classes=N_CLASSES, scene_n_classes=10,
    upsampling='learned-3x3-zeropad',
    prediction_upsampling='learned-3x3-zeropad',
)


def jax_model(defer='all'):
    from nicr_mtsa_tpu.models.multi_task import (
        MultiTaskModelConfig, build_model,
    )
    return build_model(MultiTaskModelConfig(
        defer_semantic_prediction_upsampling=defer, **CONFIG_KWARGS))


def torch_model(defer='all', seed=0):
    from nicr_mtsa_tpu_torch.models.multi_task import (
        MultiTaskModelConfig, build_model,
    )
    return build_model(MultiTaskModelConfig(
        defer_semantic_prediction_upsampling=defer, **CONFIG_KWARGS),
        device='cpu', seed=seed)


def _randomise(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomise(v, rng)
        elif k == 'mean':
            tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k in ('var', 'scale'):
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == 'bias' and v.ndim == 1:
            tree[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)


def jax_variables(model, seed=0):
    """Randomly initialised flax variables as nested numpy dicts."""
    x = {'rgb': jnp.zeros((1, H, W, 3)), 'depth': jnp.zeros((1, H, W, 1))}
    v = jax.jit(lambda k: model.init({'params': k}, x, train=False))(
        jax.random.PRNGKey(seed))
    v = jax.tree_util.tree_map(lambda a: np.array(a), v)
    v = {k: dict(c) for k, c in v.items()}
    _randomise(v, np.random.default_rng(seed))
    return v


def shaped_variables(model, seed=0):
    """Flax variables of `model` (the small config, any deferral) as
    nested numpy dicts without a compiled JAX init (~20 s on the CPU):
    the tree shaped by `jax.eval_shape`, filled from the port's model
    initialised from `seed`, then the norms and 1-D biases randomised
    as in `jax_variables`."""
    from nicr_mtsa_tpu_torch.utils.flax_weights import torch_to_flax_variables
    x = {'rgb': jnp.zeros((1, H, W, 3)), 'depth': jnp.zeros((1, H, W, 1))}
    template = jax.eval_shape(lambda: model.init(
        {'params': jax.random.PRNGKey(seed)}, x, train=False))
    v = torch_to_flax_variables(torch_model(seed=seed), template)
    v = {k: dict(c) for k, c in v.items()}
    _randomise(v, np.random.default_rng(seed))
    return v


def inputs(seed=0, B=2):
    rng = np.random.default_rng(seed)
    rgb = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    depth = rng.normal(size=(B, H, W, 1)).astype(np.float32)
    return rgb, depth


def to_nchw(a):
    return torch.from_numpy(np.array(a.transpose(0, 3, 1, 2), order='C'))


def to_nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def hwio_to_torch(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
