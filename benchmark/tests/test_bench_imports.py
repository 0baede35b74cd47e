"""No JAX in a run: the check by whole top-level names, and the reference
that imports nothing of the program."""

import subprocess
import sys
import types

from conftest import BENCH

from dfbench import loop


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("dynfu_tpu_torch.ops.knn", "jax_like", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert loop.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dynfu_tpu.core",
                        types.ModuleType("dynfu_tpu.core"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert loop.forbidden_modules() == ["dynfu_tpu", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import plainref.engine.dynfusion, plainref.engine.kinfu; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'dynfu_tpu_torch', 'dynfu_tpu', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_harness_loads_no_jax():
    """The harness, the program and the reference together in one process
    (as a run loads them) bring in no JAX."""
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "from dfbench import loop, check; "
            "import dynfu_tpu_torch.engine.dynfusion, "
            "dynfu_tpu_torch.engine.kinfu, plainref.engine.dynfusion; "
            "print(loop.forbidden_modules())"
            % (str(BENCH), str(BENCH.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
