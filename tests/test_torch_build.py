"""The ctypes signatures of the kernel library against its C sources.

``kernels/build.py:SIGNATURES`` gives ctypes the argument types of every
C entry point of ``kernels/csrc/*.cu``.  A list that is short, or that
passes a pointer as ``c_int``, truncates pointers on the card without an
error at the call; this file catches that on the CPU, where the sources
cannot be compiled.
"""
import ctypes
import re
from pathlib import Path

import pytest

from repro_torch.kernels import build

ENTRY = re.compile(r'extern\s+"C"\s+int\s+(repro_\w+)\s*\(([^)]*)\)', re.S)
SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float,
           "long long": ctypes.c_longlong}


def _params(args):
    """[(scalar type or pointee text, is pointer)] of a C argument list."""
    params = []
    for arg in args.split(","):
        words = re.sub(r"\bconst\b", "", arg).split()
        text = " ".join(words)
        if "*" in text:
            params.append((text.split("*")[0].strip(), True))
        else:  # the type without the parameter's own name
            params.append((" ".join(words[:-1]), False))
    return params


def _entries():
    """{name: _params} of every C entry point of the sources."""
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for name, args in ENTRY.findall(src.read_text()):
            assert name not in found, f"{name} defined twice"
            found[name] = _params(args)
    return found


ENTRIES = _entries()


def test_every_entry_point_has_a_signature():
    assert len(ENTRIES) >= 8
    assert set(ENTRIES) == set(build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_signature_matches_the_source(name):
    params = ENTRIES[name]
    argtypes = build.SIGNATURES[name]
    assert len(argtypes) == len(params), (name, len(argtypes), len(params))
    for i, ((base, ptr), t) in enumerate(zip(params, argtypes)):
        if ptr:
            assert t is ctypes.c_void_p, (name, i, base, t)
        else:
            assert SCALARS[base] is t, (name, i, base, t)


def test_parser_reads_pointers_and_scalars():
    src = ('extern "C" int repro_x(const void* a, void *b, int c,\n'
           '                       long long d, float e, void* stream) {')
    (name, args), = ENTRY.findall(src)
    assert name == "repro_x"
    assert _params(args) == [("void", True), ("void", True), ("int", False),
                             ("long long", False), ("float", False),
                             ("void", True)]
