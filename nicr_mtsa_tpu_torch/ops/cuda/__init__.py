"""Hand-written CUDA kernels of the serving path (sm_90a), with their
plain PyTorch versions. `KERNELS` lists each wrapper, whose `launches`
attribute counts the kernel launches it made."""
from ._build import build_all
from .finisher4x import (finish_deferred_semantic2, upsample4x_argmax_score,
                         upsample4x_argmax_score_reference)
from .grouping import group_pixels_kernel, group_pixels_reference

KERNELS = {'finisher4x': upsample4x_argmax_score,
           'grouping': group_pixels_kernel}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ['build_all', 'finish_deferred_semantic2',
           'upsample4x_argmax_score', 'upsample4x_argmax_score_reference',
           'group_pixels_kernel', 'group_pixels_reference', 'KERNELS',
           'reset_launch_counts']
