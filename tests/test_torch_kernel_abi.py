"""The kernels' C entry points against the ctypes argument types their
wrappers declare: ctypes passes an argument beyond the declared ones as a C
int, which would cut a pointer or the stream to 32 bits."""
import ctypes
import re
from pathlib import Path

import pytest

from temporalstereo_tpu_torch.kernels import cost, mark, shift, splat

CSRC = (Path(__file__).resolve().parents[1] / "temporalstereo_tpu_torch"
        / "kernels" / "csrc")
C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float, "longlong": ctypes.c_longlong}


def _signatures():
    sigs = {}
    for path in CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       path.read_text()):
            types = []
            for param in params.split(","):
                words = param.replace("*", " * ").split()[:-1]
                key = "".join(w for w in words if w != "const")
                types.append(C_TYPES[key])
            sigs[name] = types
    return sigs


@pytest.mark.parametrize("module", (cost, shift, splat, mark),
                         ids=("cost", "shift", "splat", "mark"))
def test_argtypes_match_the_c_entry_points(module):
    sigs = _signatures()
    for name, argtypes in module.ARGTYPES.items():
        assert name in sigs, f"no extern \"C\" {name} in csrc/"
        assert list(argtypes) == sigs[name], name


def test_every_entry_point_has_argtypes():
    declared = {**cost.ARGTYPES, **shift.ARGTYPES, **splat.ARGTYPES,
                **mark.ARGTYPES}
    assert sorted(declared) == sorted(_signatures())
