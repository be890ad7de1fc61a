"""Checkpoint policy (own copy of nicr_mtsa_tpu/utils/checkpointing.py):
which validation metrics trigger a checkpoint.

- A metric shorthand ('miou', 'bacc', 'miou+bacc') resolves against the
  validation logs of the first check: a substring match over the keys
  holding 'valid' and not 'best'; no match or several raise.
- The direction of improvement comes from the name (miou, acc, rq, sq
  and pq rise; mae, rmse and loss fall).
- A combined shorthand ('a+b') tracks the sum of its parts.

The format of a checkpoint is parallel/checkpoint.py's."""
from copy import deepcopy
from typing import Any, Dict, List, Optional, Sequence, Tuple

_ASCENDING_HINTS = ('miou', 'acc', 'rq', 'sq', 'pq')
_DESCENDING_HINTS = ('mae', 'rmse', 'loss')


def _resolve_shorthand(shorthand: str,
                       logs: Dict[str, Any]) -> Tuple[str, ...]:
    """Each '+'-joined part of `shorthand` as exactly one log key."""
    resolved: List[str] = []
    for part in shorthand.split('+'):
        hits = [k for k in logs
                if part in k and 'valid' in k and 'best' not in k]
        if len(hits) != 1:
            if not hits:
                raise ValueError(
                    f"No suitable metric found for '{part}'. "
                    f"Available keys for matching: {list(logs.keys())}")
            raise ValueError(
                f"Multiple suitable metrics: '{hits}' for '{part}' found.")
        resolved.append(hits[0])
    return tuple(resolved)


def _improved(shorthand: str, new_value, best_so_far) -> bool:
    ascending = any(h in shorthand for h in _ASCENDING_HINTS)
    descending = any(h in shorthand for h in _DESCENDING_HINTS)
    if ascending == descending:
        raise ValueError(
            f"Cannot determine better value for '{shorthand}' "
            f"(new: '{new_value}' '>' vs. '<' old: '{best_so_far}').")
    if best_so_far is None:
        return True
    return (new_value > best_so_far) if ascending \
        else (new_value < best_so_far)


class CheckpointHelper:
    """Track the best validation metrics and decide when to save."""

    def __init__(self, metric_names: Optional[Sequence[str]] = None,
                 debug: bool = True) -> None:
        # None: no checkpoints at all
        self._shorthands = tuple(metric_names) if metric_names else None
        self._resolved: Optional[Dict[str, Tuple[str, ...]]] = None
        self._bests: Dict[str, Any] = {}
        self._debug = debug

    @property
    def metric_mapping(self) -> Optional[Dict[str, Tuple[str, ...]]]:
        if self._shorthands is None:
            return None
        # before the first check: the unresolved skeleton
        return self._resolved if self._resolved is not None \
            else {name: [] for name in self._shorthands}

    @property
    def metric_mapping_joined(self) -> Dict[str, str]:
        mapping = self.metric_mapping
        if not mapping:
            return {}
        return {name: '+'.join(keys) for name, keys in mapping.items()}

    @staticmethod
    def _combined_value(keys: Tuple[str, ...], logs: Dict[str, Any]):
        total = logs[keys[0]]
        for key in keys[1:]:
            total = total + logs[key]
        return total

    def check_for_checkpoint(self, logs: Dict[str, Any],
                             add_checkpoint_metrics_to_logs: bool = True
                             ) -> Dict[str, bool]:
        """{metric_name: True} for the metrics at a new best; with
        `add_checkpoint_metrics_to_logs` each tracked value is logged as
        'ckpt_<keys>'."""
        if self._shorthands is None:
            return {}
        if self._resolved is None:
            self._resolved = {name: _resolve_shorthand(name, logs)
                              for name in self._shorthands}
            if self._debug:
                print(f"Using '{self._resolved}' for checkpointing.")
        wants_checkpoint: Dict[str, bool] = {}
        for name, keys in self._resolved.items():
            value = self._combined_value(keys, logs)
            if _improved(name, value, self._bests.get(name)):
                if self._debug:
                    print(f"Checkpoint metric '{name}: {keys}' reached "
                          f"new best value! (new: '{value}', old: "
                          f"'{self._bests.get(name)}')")
                self._bests[name] = value
                wants_checkpoint[name] = True
            if add_checkpoint_metrics_to_logs:
                logs[f'ckpt_{self.metric_mapping_joined[name]}'] = \
                    deepcopy(value)
        return wants_checkpoint
