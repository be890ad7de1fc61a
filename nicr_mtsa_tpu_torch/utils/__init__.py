from ._printing import cprint, cprint_section, cprint_step
from .checkpointing import CheckpointHelper
from .csv_logger import CSVLogger
from .device import resolve_device

__all__ = ['cprint', 'cprint_section', 'cprint_step', 'CheckpointHelper',
           'CSVLogger', 'resolve_device']
