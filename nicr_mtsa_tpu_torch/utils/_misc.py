"""Config helpers (own copy of nicr_mtsa_tpu/utils/_misc.py).

`partial_class` is the reference's universal config mechanism: a
cached class factory baking kwargs into `__init__`, so registry-
configured components ("types" with pre-bound kwargs) work as
there."""
import functools


@functools.lru_cache(maxsize=None)
def _partial_class_cached(cls, kwargs_tuple):
    kwargs = dict(kwargs_tuple)

    class _PartialClass(cls):
        __doc__ = cls.__doc__

        def __init__(self, *args, **kw):
            super().__init__(*args, **{**kwargs, **kw})

    _PartialClass.__name__ = cls.__name__
    _PartialClass.__qualname__ = cls.__qualname__
    return _PartialClass


def partial_class(cls, **kwargs):
    """Return a subclass of `cls` with `kwargs` pre-bound to __init__."""
    try:
        key = tuple(sorted(kwargs.items()))
        return _partial_class_cached(cls, key)
    except TypeError:
        # unhashable kwargs (e.g. arrays): build uncached
        class _PartialClass(cls):
            def __init__(self, *args, **kw):
                super().__init__(*args, **{**kwargs, **kw})
        _PartialClass.__name__ = cls.__name__
        _PartialClass.__qualname__ = cls.__qualname__
        return _PartialClass
