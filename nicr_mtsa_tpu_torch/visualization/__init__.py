"""Visualisations of predictions and targets (counterpart of
nicr_mtsa_tpu/visualization/): numpy in, numpy (H, W, 3) uint8 out; the
`*_pil` names return the same arrays (write them with
`data.png.write_png`)."""
from ._colors import (InstanceColorGenerator, PanopticColorGenerator,
                      generate_semantic_colors)
from .dense import (to_pil_img, visualize_depth, visualize_depth_pil,
                    visualize_heatmap, visualize_heatmap_pil,
                    visualize_normal, visualize_normal_pil,
                    visualize_semantic, visualize_semantic_pil)
from .instance import (visualize_instance, visualize_instance_center,
                       visualize_instance_center_pil,
                       visualize_instance_offset,
                       visualize_instance_offset_pil,
                       visualize_instance_orientations,
                       visualize_instance_orientations_pil,
                       visualize_instance_pil, visualize_orientation,
                       visualize_orientation_pil)
from .panoptic import visualize_panoptic, visualize_panoptic_pil

__all__ = [
    'InstanceColorGenerator', 'PanopticColorGenerator',
    'generate_semantic_colors', 'to_pil_img', 'visualize_depth',
    'visualize_depth_pil', 'visualize_heatmap', 'visualize_heatmap_pil',
    'visualize_normal', 'visualize_normal_pil', 'visualize_semantic',
    'visualize_semantic_pil', 'visualize_instance',
    'visualize_instance_center', 'visualize_instance_center_pil',
    'visualize_instance_offset', 'visualize_instance_offset_pil',
    'visualize_instance_orientations',
    'visualize_instance_orientations_pil', 'visualize_instance_pil',
    'visualize_orientation', 'visualize_orientation_pil',
    'visualize_panoptic', 'visualize_panoptic_pil']
