"""The whole-name import check and what the reference imports."""
import subprocess
import sys

import pytest

from _tiny import BENCH, ROOT
from lamina_bench import guard


@pytest.mark.parametrize("name,bad", [
    ("repro_torch", False), ("repro_torch.serving.llm_engine", False),
    ("repro", True), ("repro.models.transformer", True), ("jax", True),
    ("jaxlib.xla_client", True), ("flax.linen", True), ("jax_foo", False),
    ("reprox", False)])
def test_whole_top_level_names(name, bad):
    assert (guard.forbidden_modules([name, "numpy"]) == [name]) is bad


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import lamina_bench.reference.model, lamina_bench.judge; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_reference_sources_name_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "import repro" not in text and "from repro" not in text
        assert "import jax" not in text and "from jax" not in text
