"""Each C parameter struct of ``src/repro_torch/csrc`` against its mirror.

A kernel takes one struct of pointers, ints and floats, which its Python
wrapper fills through a ``ctypes.Structure``.  A field added, dropped or
moved on one side only hands the kernel shifted pointers, and nothing
would say so before the card.  These tests read the sources here: every
``struct`` a source marks ``Mirrored by repro_torch/kernels/<module>.py::
<class>`` has the class's fields, in order and of the same kind.
"""

import ctypes
import importlib
import re
from pathlib import Path

import pytest

import repro_torch

CSRC = Path(repro_torch.__file__).resolve().parent / "csrc"
_MIRROR = re.compile(r"// Mirrored by repro_torch/kernels/(\w+)\.py::(\w+)\."
                     r"\nstruct (\w+) \{\n(.*?)\n\};", re.S)
_CTYPES_KIND = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
                ctypes.c_longlong: "int64", ctypes.c_float: "float"}


def _mirrors() -> list[tuple]:
    return [(path.name, *found) for path in sorted(CSRC.glob("*.cu"))
            for found in _MIRROR.findall(path.read_text())]


def _c_fields(body: str) -> list[tuple[str, str]]:
    """(name, kind) of each field: ``ptr``, ``int``, ``int64``,
    ``float`` or ``array`` (a fixed-length array of structs)."""
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.split()).replace("long long", "int64")
        if not decl:
            continue
        m = re.fullmatch(r"(?:const )?(\w+)(\*?) (.+)", decl)
        assert m, decl
        ctype, star, names = m.groups()
        for name in names.split(","):
            name = name.strip()
            if "[" in name:
                fields.append((name.split("[")[0], "array"))
            else:
                fields.append((name, "ptr" if star else ctype))
    return fields


def _py_fields(cls) -> list[tuple[str, str]]:
    return [(name, "array" if issubclass(typ, ctypes.Array)
             else _CTYPES_KIND[typ]) for name, typ in cls._fields_]


def test_every_kernel_source_names_its_mirror():
    named = {src for src, *_ in _mirrors()}
    assert named == {p.name for p in CSRC.glob("*.cu")}


@pytest.mark.parametrize("mirror", _mirrors(),
                         ids=lambda m: f"{m[0]}::{m[3]}")
def test_struct_mirror_has_the_c_fields(mirror):
    _, module, cls, _, body = mirror
    py = getattr(importlib.import_module(f"repro_torch.kernels.{module}"),
                 cls)
    assert _py_fields(py) == _c_fields(body)
