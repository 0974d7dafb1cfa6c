"""The port's kernel library against its build list, from the text of the
sources alone (no nvcc): every CUDA source is built, every launcher the
loader binds is exported by one source and called by a wrapper, and every
launch counter is counted somewhere, so that a kernel nothing launches
cannot sit in the library unnoticed."""

import os.path as osp
import re
from glob import glob

from treelearn_tpu_torch.ops import _cuda

OPS = osp.dirname(osp.abspath(_cuda.__file__))
EXPORT = re.compile(r'extern "C" int (\w+)\(')


def _exports():
    """{source: [launcher names it exports]} for every source in csrc/."""
    out = {}
    for path in sorted(glob(osp.join(_cuda.CSRC, "*.cu"))):
        with open(path) as f:
            out[osp.basename(path)] = EXPORT.findall(f.read())
    return out


def _wrapper_text():
    text = []
    for path in sorted(glob(osp.join(OPS, "*.py"))):
        with open(path) as f:
            text.append(f.read())
    return "\n".join(text)


def test_every_source_is_built():
    assert sorted(_exports()) == sorted(_cuda.SOURCES)
    assert len(set(_cuda.SOURCES)) == len(_cuda.SOURCES)


def test_bound_launchers_are_the_exported_ones():
    """Each name of ``_SIGNATURES`` is exported by exactly one source, no
    source exports a launcher the loader does not bind, and a wrapper under
    ops/ calls each one."""
    exported = [n for names in _exports().values() for n in names]
    assert sorted(exported) == sorted(_cuda._SIGNATURES)
    text = _wrapper_text()
    for name in _cuda._SIGNATURES:
        assert f".{name}(" in text, name


def test_every_launch_counter_is_counted():
    text = _wrapper_text()
    for name in _cuda.LAUNCHES:
        assert f'LAUNCHES["{name}"] += 1' in text, name
