"""Each kernel source's C interface against its module's ctypes argtypes.

The kernels are loaded with ctypes, which passes whatever the argtypes
say: a parameter added to a C function but not to ``_SIGNATURES`` (or a
pointer declared as an int) shifts every later argument, and no CPU test
would notice, since the kernels build and run only on the card.  This
parses every ``extern "C"`` function of each source under ``csrc/`` and
holds its parameter count and kinds against the module's table.
"""
import ctypes
import re

import pytest

from multigrad_tpu_torch.ops import (cuda_build, erf_kernels, fused_kernels,
                                     pair_kernels)

MODULES = {"erf_counts.cu": erf_kernels, "fused_counts.cu": fused_kernels,
           "pair_counts.cu": pair_kernels}
KIND_OF_CTYPE = {ctypes.c_void_p: "pointer", ctypes.c_longlong: "int64",
                 ctypes.c_int: "int32", ctypes.c_float: "float32"}


def _kind(param):
    """The ctypes kind of one C parameter declaration."""
    if "*" in param:
        return "pointer"
    words = param.split()[:-1]      # the type without the name
    kinds = {("long", "long"): "int64", ("int",): "int32",
             ("float",): "float32"}
    return kinds[tuple(w for w in words if w != "const")]


def c_functions(source):
    """``{name: [kind, ...]}`` of the functions in ``source``'s ``extern
    "C"`` block."""
    text = (cuda_build.CSRC / source).read_text()
    block = text.split('extern "C" {', 1)[1]
    block = re.sub(r"//[^\n]*", "", block)
    return {m.group(1): [_kind(p) for p in m.group(2).split(",")]
            for m in re.finditer(r"\bint\s+(\w+)\s*\(([^)]*)\)\s*\{", block)}


def test_every_source_has_a_module():
    assert set(MODULES) == set(cuda_build.SOURCES)


@pytest.mark.parametrize("source", sorted(MODULES))
def test_c_interface_matches_signatures(source):
    module = MODULES[source]
    assert module.SOURCE == source
    declared = c_functions(source)
    expected = {name: [KIND_OF_CTYPE[t] for t in argtypes]
                for name, argtypes in module._SIGNATURES.items()}
    assert declared == expected
