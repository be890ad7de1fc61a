"""The synthetic sample of the tests (own copy of
nicr_mtsa_tpu/testing/preprocessing.py): a 512 x 512 RGB-D sample with
hand-placed rectangular instances, semantics and orientations;
instance 3 sits on a stuff class (10), so the target generators skip
it. The same pixels as the JAX package's `get_dummy_sample`."""
import numpy as np

from ..data._types import AppliedPreprocessingMeta
from ..data.fullres import APPLIED_PREPROCESSING_KEY


def _synthetic_rgb(h: int = 512, w: int = 512) -> np.ndarray:
    """A deterministic colourful image with structure at several
    scales."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    r = (xx * 255 // max(w - 1, 1)).astype(np.uint8)
    g = ((np.sin(yy / 17.0) * 0.5 + 0.5) * 255).astype(np.uint8)
    b = (((xx // 32 + yy // 32) % 2) * 160 + 40).astype(np.uint8)
    noise = np.random.default_rng(12345).integers(0, 40, size=(h, w, 3),
                                                  dtype=np.uint8)
    img = np.stack([r, g, b], axis=-1)
    return np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def get_dummy_sample() -> dict:
    img = _synthetic_rgb(512, 512)
    depth = img[..., 0].copy().astype('uint16') * 2 ** 6
    instance = np.zeros(depth.shape, dtype='uint8')
    instance[40:100, 40:100] = 1
    instance[150:200, 40:100] = 2
    instance[0:200, 200:250] = 3     # a stuff instance: skipped
    instance[300:400, 200:250] = 4
    semantic = np.zeros(depth.shape, dtype='uint8')
    semantic[40:100, 40:100] = 1
    semantic[150:200, 40:100] = 2
    semantic[0:200, 200:250] = 10    # a stuff class
    semantic[300:400, 200:250] = 3
    return {
        'rgb': img,
        'depth': depth,
        'instance': instance,
        'semantic': semantic,
        'some_mask': img[..., 1] > 100,
        'orientations': {1: np.deg2rad(45), 2: np.deg2rad(90),
                         3: np.deg2rad(135)},
        'scene': 0,
        APPLIED_PREPROCESSING_KEY: AppliedPreprocessingMeta(),
    }


# the tests' thing/stuff split: 11 semantic classes (0 = void), of
# which 1, 2 and 3 are things
N_TEST_CLASSES_WITH_VOID = 11
TEST_CLASSES_IS_THING_WITH_VOID = tuple(
    i in (1, 2, 3) for i in range(N_TEST_CLASSES_WITH_VOID))
