"""Coloured console output of the run scripts (own copy of
nicr_mtsa_tpu/utils/_printing.py): ANSI SGR codes, applied only when
the stream is a terminal and NO_COLOR is not set."""
import os
import sys

_SGR = {
    'grey': 90, 'red': 31, 'green': 32, 'yellow': 33,
    'blue': 34, 'magenta': 35, 'cyan': 36, 'white': 37,
}
_ATTR = {'bold': 1, 'dark': 2, 'underline': 4, 'reverse': 7}


def _style_codes(color, attrs):
    codes = [_ATTR[a] for a in (attrs or ()) if a in _ATTR]
    if color in _SGR:
        codes.append(_SGR[color])
    return codes


def _styling_active(stream) -> bool:
    if 'NO_COLOR' in os.environ:
        return False
    isatty = getattr(stream, 'isatty', None)
    return bool(isatty and isatty())


def cprint(*values, color=None, attrs=None, **print_kwargs):
    """`print` with an optional colour and attributes (ignored where the
    stream is no terminal)."""
    print_kwargs.pop('on_color', None)
    stream = print_kwargs.get('file') or sys.stdout
    codes = _style_codes(color, attrs)
    if codes and _styling_active(stream):
        text = print_kwargs.pop('sep', ' ').join(str(v) for v in values)
        prefix = ''.join(f'\033[{c}m' for c in codes)
        print(f'{prefix}{text}\033[0m', **print_kwargs)
    else:
        print(*values, **print_kwargs)


def cprint_section(*values, **kwargs):
    """A message between two horizontal rules."""
    rule = '-' * 40
    cprint(rule, **kwargs)
    cprint(*values, **kwargs)
    cprint(rule, **kwargs)


def cprint_step(*values, **kwargs):
    """A bold blue progress message."""
    kwargs.setdefault('color', 'blue')
    kwargs.setdefault('attrs', ('bold',))
    cprint(*values, **kwargs)
