"""Decoder bases (counterpart of nicr_mtsa_tpu/models/decoders/base.py);
both return `(main, side_outputs)`.

- `DenseDecoderBase`: the dense ladder; each step is ConvNormAct 3x3 +
  n residual blocks (NonBottleneck1D's channel dropout in training,
  drawn from the generator passed to `forward`; with `remat` they
  recompute their activations in the backward pass, models/remat.py)
  + 2x upsampling, followed by skip fusion. In training mode every
  step that upsamples also gives its features before the upsampling
  to a side head (`side_head{i}`), and those predictions are the side
  outputs; the side heads exist where the decoder is built with
  `side_heads=True` (the parameters of the JAX package's `init(...,
  train=True)`). In eval mode there are no side outputs.
- `MLPDecoderBase`: SegFormer-style; a 1x1 embedding of the context
  features and of each (selected, LayerNormed) skip, all upsampled to
  `downsampling_in_heads`, concatenated, fused by a 1x1 ConvNormAct,
  channel dropout (rate `dropout_p`, training mode only, drawn from the
  generator passed to `forward`), then the task head: in training as
  at inference the full-resolution bilinear prediction and no side
  outputs."""
from typing import Optional, Tuple

import torch.nn as nn

from ..blocks import make_block
from ..common import ConvNormAct, Dropout
from ..encoder_decoder_fusion import (EncoderDecoderFusion,
                                      parse_encoder_decoder_fusion)
from ..upsampling import Upsampling


def plan_dense_ladder(downsampling_in: int, downsamplings: Tuple[int, ...],
                      fusion_downsamplings: Tuple[int, ...]):
    """Per-step {do_upsampling, fusion_ds} and the side-output
    downscales (reference dense_base.py:128-200): a step that upsamples
    gives a side output at its input's downsampling."""
    assert sorted(downsamplings, reverse=True) == list(downsamplings)
    assert all(d <= downsampling_in for d in downsamplings)
    cur = downsampling_in
    modules, downscales = [], []
    for ds in downsamplings:
        up = ds < cur
        if up:
            downscales.append(cur)
            cur = ds
        modules.append({
            'do_upsampling': up,
            'fusion_ds': cur if cur in fusion_downsamplings else -1})
    return modules, tuple(downscales)


class DenseDecoderModule(nn.Module):
    def __init__(self, n_in: int, n_channels: int,
                 block: str = 'nonbottleneck1d', n_blocks: int = 3,
                 norm: str = 'batchnorm', act: str = 'relu',
                 upsampling=None, remat: bool = False, generator=None):
        super().__init__()
        self.conv = ConvNormAct(n_in, n_channels, 3, norm=norm, act=act,
                                generator=generator)
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f'block{i}', make_block(
                block, n_in=n_channels, planes=n_channels, stride=1,
                use_downsample=False, norm=norm, act=act, remat=remat,
                generator=generator))
        self.upsample = (Upsampling(upsampling, n_channels)
                         if upsampling is not None else None)

    def forward(self, x, generator=None):
        """(output, the features before the upsampling); `generator`
        feeds the blocks' dropout in training."""
        x = self.conv(x)
        for i in range(self.n_blocks):
            x = getattr(self, f'block{i}')(x, generator)
        side = x
        if self.upsample is not None:
            x = self.upsample(x)
        return x, side


class DenseDecoderBase(nn.Module):
    def __init__(self, n_channels_in: int = 512, downsampling_in: int = 32,
                 n_channels: Tuple[int, ...] = (512, 256, 128),
                 downsamplings: Tuple[int, ...] = (16, 8, 4),
                 block: str = 'nonbottleneck1d', n_blocks: int = 3,
                 fusion: str = 'add-rgb',
                 fusion_n_channels: Tuple[int, ...] = (),
                 fusion_downsamplings: Tuple[int, ...] = (16, 8, 4),
                 norm: str = 'batchnorm', act: str = 'relu',
                 upsampling: str = 'learned-3x3-zeropad',
                 prediction_upsampling: str = 'learned-3x3-zeropad',
                 side_heads: bool = False, remat: bool = False,
                 generator=None):
        super().__init__()
        assert len(fusion_n_channels) == len(fusion_downsamplings)
        self.downsamplings = tuple(downsamplings)
        self.prediction_upsampling = prediction_upsampling
        self.norm, self.act = norm, act
        plan, _ = plan_dense_ladder(downsampling_in, self.downsamplings,
                                    tuple(fusion_downsamplings))
        fusion_cfg = parse_encoder_decoder_fusion(fusion)
        self._fusion_ds = []
        # built by the subclass (`side_head{i}`) after its task head
        self.side_heads = side_heads
        self.side_output_n_channels = tuple(
            n for n, p in zip(n_channels, plan) if p['do_upsampling'])
        n_prev = n_channels_in
        fusion_idx = 0
        for i, (n_out, p) in enumerate(zip(n_channels, plan)):
            self.add_module(f'module{i}', DenseDecoderModule(
                n_prev, n_out, block=block, n_blocks=n_blocks, norm=norm,
                act=act,
                upsampling=upsampling if p['do_upsampling'] else None,
                remat=remat, generator=generator))
            fds = p['fusion_ds']
            if fds != -1:
                self.add_module(f'fusion{fusion_idx}', EncoderDecoderFusion(
                    fusion_n_channels[fusion_idx], n_out, norm=norm, act=act,
                    generator=generator, **fusion_cfg))
                fusion_idx += 1
            self._fusion_ds.append(fds)
            n_prev = n_out
        self.n_channels_last = n_prev

    def apply_task_head(self, x):
        raise NotImplementedError

    def batch_statistics(self, x, skips, generator=None):
        """In training, where nothing reads the decoder's output: the
        part of the forward that moves BatchNorm statistics (the whole
        ladder and the heads)."""
        self(x, skips, generator)

    def forward(self, x, skips, generator=None):
        """x: (context_features, context_branches); skips:
        {str(ds): {modality: tensor}}; `generator` feeds the dropout in
        training. Returns (main, side_outputs): in training mode one
        side head's prediction a step that upsamples, else ()."""
        if self.training and not self.side_heads:
            raise ValueError('a dense decoder trains with its side heads: '
                             'build it with side_heads=True (build_model('
                             '..., train=True))')
        x, _ = x
        sides = []
        fusion_idx = 0
        for i, fds in enumerate(self._fusion_ds):
            module = getattr(self, f'module{i}')
            x, side = module(x, generator)
            if module.upsample is not None:
                sides.append(side)
            if fds != -1:
                x = getattr(self, f'fusion{fusion_idx}')(skips[str(fds)], x)
                fusion_idx += 1
        main = self.apply_task_head(x)
        if not self.training:
            return main, ()
        return main, tuple(getattr(self, f'side_head{i}')(s)
                           for i, s in enumerate(sides))


class MLPDecoderBase(nn.Module):
    def __init__(self, n_channels_in: int = 512, downsampling_in: int = 32,
                 n_channels: Tuple[int, ...] = (128, 128, 128, 128),
                 fusion: str = 'select-rgb',
                 fusion_n_channels: Tuple[int, ...] = (),
                 fusion_downsamplings: Tuple[int, ...] = (16, 8, 4),
                 downsampling_in_heads: int = 4,
                 dropout_p: float = 0.1,
                 n_channels_out: Optional[int] = None,
                 norm: str = 'batchnorm', act: str = 'relu',
                 upsampling: str = 'bilinear',
                 prediction_upsampling: str = 'bilinear', generator=None):
        super().__init__()
        assert len(n_channels) == 1 + len(fusion_n_channels)
        assert len(fusion_n_channels) == len(fusion_downsamplings)
        self.downsampling_in_heads = downsampling_in_heads
        self.prediction_upsampling = prediction_upsampling
        self.norm, self.act = norm, act
        self.fusion_downsamplings = tuple(fusion_downsamplings)
        fusion_cfg = parse_encoder_decoder_fusion(fusion)
        self.main_embedding = ConvNormAct(n_channels_in, n_channels[0], 1,
                                          norm=None, act=None,
                                          generator=generator)
        self.main_upsample = Upsampling(
            upsampling, n_channels[0],
            scale_factor=downsampling_in // downsampling_in_heads)
        for i, (n_skip, n_dec) in enumerate(zip(fusion_n_channels,
                                                n_channels[1:])):
            ds = self.fusion_downsamplings[i]
            self.add_module(f'skip_fusion{i}', EncoderDecoderFusion(
                n_skip, n_skip, norm=norm, act=act, generator=generator,
                **fusion_cfg))
            self.add_module(f'skip_embedding{i}', ConvNormAct(
                n_skip, n_dec, 1, norm=None, act=None, generator=generator))
            self.add_module(f'skip_upsample{i}', Upsampling(
                upsampling, n_dec, scale_factor=ds // downsampling_in_heads))
        self.head_n_channels = (n_channels_out if n_channels_out is not None
                                else sum(n_channels) // len(n_channels))
        self.fuse = ConvNormAct(sum(n_channels), self.head_n_channels, 1,
                                norm=norm, act=act, generator=generator)
        self.dropout = Dropout(dropout_p)

    def apply_task_head(self, x):
        raise NotImplementedError

    def _fused(self, x, skips):
        x, _ = x
        features = [self.main_upsample(self.main_embedding(x))]
        for i, ds in enumerate(self.fusion_downsamplings):
            sel = getattr(self, f'skip_fusion{i}')(skips[str(ds)], None)
            sel = getattr(self, f'skip_embedding{i}')(sel)
            features.append(getattr(self, f'skip_upsample{i}')(sel))
        return self.fuse(features)

    def forward(self, x, skips, generator=None):
        """x: (context_features, context_branches); skips:
        {str(ds): {modality: tensor}}; `generator` feeds the dropout in
        training. Returns (main, ())."""
        return self.apply_task_head(
            self.dropout(self._fused(x, skips), generator)), ()

    def batch_statistics(self, x, skips, generator=None):
        """In training, where nothing reads the decoder's output: the
        part of the forward that moves BatchNorm statistics (up to the
        fuse's BatchNorm; the task head has none)."""
        self._fused(x, skips)
