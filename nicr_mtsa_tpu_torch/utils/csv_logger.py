"""Epoch-log CSV file (own copy of nicr_mtsa_tpu/utils/csv_logger.py):
one row a `log()` call; an existing file is read back, so a resumed run
keeps its earlier rows; the columns are the sorted union of every
row's keys (the file is rewritten whole); written on the first row and
then every `write_interval` rows, and at interpreter exit. A value may
be a Python scalar or string, or a numpy array or tensor of one
element (fetched here, once an epoch)."""
import atexit
import csv
import os
from typing import Any, Dict, List

import numpy as np
import torch


def _to_cell(value: Any) -> Any:
    """A log value as something csv writes."""
    if isinstance(value, (str, int, float)):
        return value
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().item()
    if hasattr(value, 'item'):   # numpy scalar or one-element array
        return np.asarray(value).item()
    raise NotImplementedError(
        f"CSV logging for type: '{type(value)}' is not yet implemented.")


class CSVLogger:
    """Append-style CSV logger over per-epoch log dicts."""

    def __init__(self, filepath: str, write_interval: int = 1) -> None:
        self._filepath = filepath
        self._write_interval = write_interval
        self._rows: List[Dict[str, Any]] = self._load_existing(filepath)
        atexit.register(self.write)

    @staticmethod
    def _load_existing(filepath: str) -> List[Dict[str, Any]]:
        if not os.path.isfile(filepath):
            return []
        with open(filepath, 'r') as f:
            return [dict(row) for row in csv.DictReader(f)]

    @property
    def _columns(self) -> List[str]:
        seen = set()
        for row in self._rows:
            seen.update(row)
        return sorted(seen)

    def log(self, logs: Dict[str, Any]) -> None:
        self._rows.append({k: _to_cell(v) for k, v in logs.items()})
        # the first row is written at once: a run that fails after its
        # first epoch still leaves a file
        if (len(self._rows) - 1) % self._write_interval == 0:
            self.write()

    def write(self) -> None:
        with open(self._filepath, 'w') as f:
            writer = csv.DictWriter(f, fieldnames=self._columns)
            writer.writeheader()
            writer.writerows(self._rows)
