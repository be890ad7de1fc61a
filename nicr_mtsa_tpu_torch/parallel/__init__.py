"""Training-state checkpoints (counterpart of nicr_mtsa_tpu/parallel/
checkpoint.py's `save_checkpoint` / `load_checkpoint`; the JAX
package's meshes and multi-host code are not ported yet)."""
from .checkpoint import (load_checkpoint, load_train_state, save_checkpoint,
                         train_state_dict)

__all__ = ['load_checkpoint', 'load_train_state', 'save_checkpoint',
           'train_state_dict']
