"""Task helpers of the fused eval step (counterpart of
nicr_mtsa_tpu/tasks/): losses, device metric states, epoch results."""
from .base import TaskHelperBase, get_total_loss_key
from .dense_visual_embedding import DenseVisualEmbeddingTaskHelper
from .instance import InstanceTaskHelper
from .normal import NormalTaskHelper
from .panoptic import PanopticTaskHelper
from .scene import SceneTaskHelper
from .semantic import SemanticTaskHelper

__all__ = ['TaskHelperBase', 'get_total_loss_key',
           'DenseVisualEmbeddingTaskHelper', 'InstanceTaskHelper',
           'NormalTaskHelper',
           'PanopticTaskHelper', 'SceneTaskHelper', 'SemanticTaskHelper']
