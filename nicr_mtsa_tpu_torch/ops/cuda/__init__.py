"""Hand-written CUDA kernels of the port (sm_90a), with their plain
PyTorch versions. `KERNELS` lists each wrapper, whose `launches`
attribute counts the kernel launches it made (the grouping's is the
pipeline's entry, `group_pixels_offsets`; the loc-level
`group_pixels_kernel` counts its own). The differentiable
window-attention core is `window_attention_core.window_attention_core`
and the attention over the packed qkv
`window_attention_qkv.window_attention_qkv` (the modules of the same
names are not shadowed here)."""
from ._build import build_all
from .finisher2x import (finish_deferred_semantic, upsample2x_argmax_score,
                         upsample2x_argmax_score_reference)
from .finisher4x import (finish_deferred_bilinear2,
                         finish_deferred_semantic2,
                         upsample4x_argmax_score,
                         upsample4x_argmax_score_reference,
                         upsample4x_bilinear_argmax_score,
                         upsample4x_bilinear_argmax_score_reference)
from .grouping import (group_pixels_kernel, group_pixels_offsets,
                       group_pixels_offsets_reference,
                       group_pixels_reference)
from .intersection import (intersection_matrix_kernel,
                           intersection_matrix_reference)
from .layernorm import fused_layer_norm, layer_norm_reference
from .resize_reduce import (crop_resize_argmax_score,
                            crop_resize_argmax_score_reference)
from .semantic_reduce import (semantic_argmax_score,
                              semantic_argmax_score_reference)
from .window_attention import (window_attention_block,
                               window_attention_block_reference)
from .window_attention_core import (
    dbias_reduce, dbias_reduce_reference, window_attention_core_backward,
    window_attention_core_backward_reference, window_attention_core_forward,
    window_attention_core_reference)
from . import window_attention_qkv as _window_attention_qkv

KERNELS = {'finisher4x': upsample4x_argmax_score,
           'grouping': group_pixels_offsets,
           'resize_reduce': crop_resize_argmax_score,
           'semantic_reduce': semantic_argmax_score,
           'intersection': intersection_matrix_kernel,
           'finisher4x_bilinear': upsample4x_bilinear_argmax_score,
           'window_attention_block': window_attention_block,
           'layernorm': fused_layer_norm,
           'window_attention_core_fwd': window_attention_core_forward,
           'window_attention_core_bwd': window_attention_core_backward,
           'window_attention_core_dbias': dbias_reduce,
           'finisher2x': upsample2x_argmax_score,
           'window_attention_qkv': _window_attention_qkv.window_attention_qkv}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ['build_all', 'finish_deferred_semantic',
           'upsample2x_argmax_score', 'upsample2x_argmax_score_reference',
           'finish_deferred_semantic2',
           'finish_deferred_bilinear2', 'upsample4x_argmax_score',
           'upsample4x_argmax_score_reference',
           'upsample4x_bilinear_argmax_score',
           'upsample4x_bilinear_argmax_score_reference',
           'group_pixels_kernel', 'group_pixels_reference',
           'group_pixels_offsets', 'group_pixels_offsets_reference',
           'intersection_matrix_kernel', 'intersection_matrix_reference',
           'crop_resize_argmax_score', 'crop_resize_argmax_score_reference',
           'semantic_argmax_score', 'semantic_argmax_score_reference',
           'window_attention_block', 'window_attention_block_reference',
           'fused_layer_norm', 'layer_norm_reference',
           'window_attention_core_forward',
           'window_attention_core_backward', 'window_attention_core_reference',
           'window_attention_core_backward_reference', 'dbias_reduce',
           'dbias_reduce_reference',
           'KERNELS', 'reset_launch_counts']
