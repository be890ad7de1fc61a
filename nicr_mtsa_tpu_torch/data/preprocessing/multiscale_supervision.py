"""Downscaled ground-truth copies for multiscale (side-output)
supervision (own copy of
nicr_mtsa_tpu/data/preprocessing/multiscale_supervision.py): for each
downscale k a `_down_<k>` sub-sample holds the chosen keys, nearest-
(and, for rgb, bilinearly) resized to int(edge / k); later steps with
`multiscale_processing` run on each of them."""
from .base import MULTI_DOWNSCALE_KEY_FMT, PreprocessingBase
from .clone import clone_entries
from .resize import resize
from .utils import _get_input_shape, _keys_available


def get_downscale(sample, downscale):
    return sample.get(MULTI_DOWNSCALE_KEY_FMT.format(downscale), None)


class MultiscaleSupervisionGenerator(PreprocessingBase):
    """Create the `_down_<k>` sub-samples."""

    def __init__(self, downscales, keys):
        self._downscales = tuple(downscales)
        self._keys = tuple(keys)
        # this step creates the sub-samples the fan-out would run on
        super().__init__(
            fixed_parameters={'downscales': self._downscales,
                              'keys': self._keys},
            multiscale_processing=False)

    @property
    def downscales(self):
        return self._downscales

    def _preprocess(self, sample, **kwargs):
        missing = [k for k in self._keys if not _keys_available(sample, (k,))]
        if missing:
            raise KeyError(f'multiscale supervision requires {self._keys}; '
                           f'sample is missing {missing}')
        full = _get_input_shape(sample)
        provenance = {}
        for factor in self._downscales:
            target = tuple(int(edge / factor) for edge in full)
            sample[MULTI_DOWNSCALE_KEY_FMT.format(factor)] = resize(
                clone_entries(sample, keys_to_clone=self._keys),
                height=target[0], width=target[1])
            provenance[factor] = target
        return sample, {'shapes': provenance}
