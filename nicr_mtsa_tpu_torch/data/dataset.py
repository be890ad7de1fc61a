"""Directory-backed RGB-D dataset (own copy of
nicr_mtsa_tpu/data/dataset.py): a map-style
``DirectoryRGBDDataset(dataset_path, split, sample_keys)`` of dict
samples with the `rgb` / `depth` / `semantic` / `instance` /
`orientations` / `scene` keys (host numpy arrays), a settable
``preprocessor`` applied inside ``__getitem__``, and a ``config``
with the semantic label lists (``classes_is_thing`` and the rest) and
the depth statistics.

On-disk layout:

    <root>/
      meta.json                 # dataset config, see DatasetConfig
      <split>/
        rgb/<id>.png            # (H, W, 3) uint8
        depth/<id>.png          # (H, W) uint16 (16-bit PNG) [optional]
        semantic/<id>.png       # (H, W) uint8/uint16 class ids,
                                #   0 = void                 [optional]
        instance/<id>.png       # (H, W) uint16 instance ids [optional]
        orientations/<id>.json  # {instance_id: rad}         [optional]
        scene.json              # {<id>: scene class idx}    [optional]

Any image may be a ``.npy`` instead of ``.png`` (exact dtype and
shape). Sample ids of a split are the sorted ``rgb`` basenames. PNG
files go through the port's own codec (`png.py`), not PIL.
"""
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ._types import OrientationDict
from .png import read_png, write_png

VOID_CLASS_NAME = 'void'


@dataclass(frozen=True)
class SemanticLabel:
    """One semantic class."""
    name: str
    is_thing: bool = False
    use_orientation: bool = False
    color: Tuple[int, int, int] = (0, 0, 0)


class SemanticLabelList(tuple):
    """Tuple of SemanticLabel with accessor properties
    (`classes_is_thing` and the rest)."""

    @property
    def classes_names(self) -> Tuple[str, ...]:
        return tuple(l.name for l in self)

    @property
    def classes_is_thing(self) -> Tuple[bool, ...]:
        return tuple(l.is_thing for l in self)

    @property
    def classes_use_orientations(self) -> Tuple[bool, ...]:
        return tuple(l.use_orientation for l in self)

    @property
    def classes_colors(self) -> Tuple[Tuple[int, int, int], ...]:
        return tuple(tuple(l.color) for l in self)


@dataclass
class DatasetConfig:
    """Dataset-level metadata (label lists + depth statistics).

    `semantic_label_list` includes void at index 0 (the reference's
    convention); `semantic_label_list_without_void` drops it."""
    semantic_label_list: SemanticLabelList
    scene_label_list: Tuple[str, ...] = ()
    depth_mean: float = 0.0
    depth_std: float = 1.0
    depth_mode: str = 'raw'

    @property
    def semantic_label_list_without_void(self) -> SemanticLabelList:
        return SemanticLabelList(self.semantic_label_list[1:])

    @property
    def n_semantic_classes(self) -> int:
        """Including void."""
        return len(self.semantic_label_list)

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            'semantic_classes': [
                {'name': l.name, 'is_thing': l.is_thing,
                 'use_orientation': l.use_orientation,
                 'color': list(l.color)}
                for l in self.semantic_label_list
            ],
            'scene_classes': list(self.scene_label_list),
            'depth_mean': self.depth_mean,
            'depth_std': self.depth_std,
            'depth_mode': self.depth_mode,
        }

    @classmethod
    def from_json_dict(cls, d: Dict[str, Any]) -> 'DatasetConfig':
        labels = SemanticLabelList(
            SemanticLabel(name=e['name'],
                          is_thing=bool(e.get('is_thing', False)),
                          use_orientation=bool(
                              e.get('use_orientation', False)),
                          color=tuple(e.get('color', (0, 0, 0))))
            for e in d['semantic_classes'])
        if not labels or labels[0].name != VOID_CLASS_NAME:
            raise ValueError(
                "semantic_classes[0] must be the void class "
                f"(got {labels[0].name if labels else 'nothing'})")
        return cls(
            semantic_label_list=labels,
            scene_label_list=tuple(d.get('scene_classes', ())),
            depth_mean=float(d.get('depth_mean', 0.0)),
            depth_std=float(d.get('depth_std', 1.0)),
            depth_mode=str(d.get('depth_mode', 'raw')),
        )


def _read_image(path: str) -> np.ndarray:
    """A writable array: preprocessors change samples in place."""
    if path.endswith('.npy'):
        return np.load(path)
    return read_png(path)


def _write_image(path: str, arr: np.ndarray) -> None:
    if path.endswith('.npy'):
        np.save(path, arr)
    else:
        write_png(path, arr)


# spatial sample keys stored one file per sample
_IMAGE_KEYS = ('rgb', 'depth', 'semantic', 'instance', 'normal')
DEFAULT_SAMPLE_KEYS = ('rgb', 'depth', 'semantic', 'instance',
                       'orientations', 'scene')


class DirectoryRGBDDataset:
    """Map-style dataset over the directory layout above; a
    ``preprocessor`` (``Compose([...])``) runs inside
    ``__getitem__``."""

    def __init__(
        self,
        dataset_path: str,
        split: str = 'train',
        sample_keys: Sequence[str] = DEFAULT_SAMPLE_KEYS,
        preprocessor: Optional[Callable] = None,
    ) -> None:
        meta_path = os.path.join(dataset_path, 'meta.json')
        if not os.path.isfile(meta_path):
            raise FileNotFoundError(
                f"no dataset at '{dataset_path}' (missing meta.json); "
                "see nicr_mtsa_tpu_torch/data/dataset.py for the layout")
        with open(meta_path) as f:
            self.config = DatasetConfig.from_json_dict(json.load(f))

        self._root = os.path.join(dataset_path, split)
        if not os.path.isdir(self._root):
            raise FileNotFoundError(
                f"split '{split}' not found under '{dataset_path}'")
        self.split = split
        self.sample_keys = tuple(sample_keys)
        self.preprocessor = preprocessor

        rgb_dir = os.path.join(self._root, 'rgb')
        if not os.path.isdir(rgb_dir):
            raise FileNotFoundError(f"missing '{rgb_dir}'")
        self._ids = sorted(
            os.path.splitext(f)[0] for f in os.listdir(rgb_dir)
            if f.endswith(('.png', '.npy')))
        if not self._ids:
            raise FileNotFoundError(f"no samples under '{rgb_dir}'")

        scene_path = os.path.join(self._root, 'scene.json')
        self._scenes: Dict[str, int] = {}
        if os.path.isfile(scene_path):
            with open(scene_path) as f:
                self._scenes = {str(k): int(v)
                                for k, v in json.load(f).items()}

    @staticmethod
    def is_available(dataset_path: Optional[str]) -> bool:
        """True when `dataset_path` points at a readable dataset root
        (drives auto-skip in tests/benches)."""
        return bool(dataset_path) and os.path.isfile(
            os.path.join(dataset_path, 'meta.json'))

    def __len__(self) -> int:
        return len(self._ids)

    def _find(self, key: str, sid: str) -> Optional[str]:
        for ext in ('.png', '.npy'):
            p = os.path.join(self._root, key, sid + ext)
            if os.path.isfile(p):
                return p
        return None

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        sid = self._ids[idx]
        sample: Dict[str, Any] = {'identifier': (self.split, sid)}
        for key in self.sample_keys:
            if key in _IMAGE_KEYS:
                path = self._find(key, sid)
                if path is None:
                    raise FileNotFoundError(
                        f"sample '{sid}' has no '{key}' file")
                sample[key] = _read_image(path)
            elif key == 'orientations':
                path = os.path.join(self._root, 'orientations',
                                    sid + '.json')
                od = OrientationDict()
                if os.path.isfile(path):
                    with open(path) as f:
                        od.update({int(k): float(v)
                                   for k, v in json.load(f).items()})
                sample[key] = od
            elif key == 'scene':
                sample[key] = self._scenes.get(sid, 0)
            elif key == 'identifier':
                pass
            else:
                raise KeyError(f"unknown sample key '{key}'")
        if self.preprocessor is not None:
            sample = self.preprocessor(sample)
        return sample


def write_directory_dataset(
    dataset_path: str,
    split: str,
    samples: Sequence[Dict[str, Any]],
    config: DatasetConfig,
    image_format: str = 'png',
) -> None:
    """Write in-memory samples into the directory layout (fixture
    generation and dataset conversion). Each sample may carry any
    subset of the image keys plus 'orientations' and 'scene'; ids are
    zero-padded indices unless an 'identifier' is present."""
    os.makedirs(dataset_path, exist_ok=True)
    with open(os.path.join(dataset_path, 'meta.json'), 'w') as f:
        json.dump(config.to_json_dict(), f, indent=1)
    root = os.path.join(dataset_path, split)
    scenes: Dict[str, int] = {}
    for i, sample in enumerate(samples):
        sid = sample.get('identifier', (split, f'{i:04d}'))[-1]
        for key in _IMAGE_KEYS:
            if key not in sample:
                continue
            d = os.path.join(root, key)
            os.makedirs(d, exist_ok=True)
            arr = np.asarray(sample[key])
            ext = ('.npy' if image_format == 'npy'
                   or arr.dtype not in (np.uint8, np.uint16)
                   else '.png')
            _write_image(os.path.join(d, sid + ext), arr)
        if 'orientations' in sample and len(sample['orientations']):
            d = os.path.join(root, 'orientations')
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, sid + '.json'), 'w') as f:
                json.dump({str(k): float(v)
                           for k, v in sample['orientations'].items()},
                          f)
        if 'scene' in sample:
            scenes[sid] = int(sample['scene'])
    if scenes:
        with open(os.path.join(root, 'scene.json'), 'w') as f:
            json.dump(scenes, f, indent=0)


def get_dataset(
    dataset_path: str,
    split: str = 'train',
    sample_keys: Sequence[str] = DEFAULT_SAMPLE_KEYS,
    **kwargs: Any,
) -> DirectoryRGBDDataset:
    """The dataset at `dataset_path`; a bare name such as 'nyuv2' that
    is no directory is looked up under the directory named by the
    NICR_MTSA_DATASETS environment variable."""
    if not os.path.isdir(dataset_path):
        base = os.environ.get('NICR_MTSA_DATASETS', '')
        candidate = os.path.join(base, dataset_path)
        if base and os.path.isdir(candidate):
            dataset_path = candidate
    return DirectoryRGBDDataset(dataset_path, split=split,
                                sample_keys=sample_keys, **kwargs)
