"""What the benchmark imports: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or the JAX package ``temporalstereo_tpu`` (names
compared whole: the port ``temporalstereo_tpu_torch`` is allowed), and in
``reference/`` nothing of the port either."""
import ast

import pytest

from stereo_bench.conftest import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "temporalstereo_tpu"}


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_names_are_compared_whole():
    assert "temporalstereo_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = _top_level_imports(path)
    assert "temporalstereo_tpu_torch" not in names
    assert names <= {"__future__", "dataclasses", "typing", "torch"}
