from ._misc import partial_class
from ._printing import cprint, cprint_section, cprint_step
from .checkpointing import CheckpointHelper
from .csv_logger import CSVLogger
from .device import resolve_device

__all__ = ['cprint', 'cprint_section', 'cprint_step', 'CheckpointHelper',
           'CSVLogger', 'partial_class', 'resolve_device']
