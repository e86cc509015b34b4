"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (the port's own name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import subprocess
import sys

from portbench import common

PORT = "superresolution_tpu_torch"


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(common.BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = top_level_imports(f) & set(common.FORBIDDEN_MODULES)
        assert not bad, f"{f} imports {bad}"


def test_the_whole_name_is_compared():
    assert "superresolution_tpu" in common.FORBIDDEN_MODULES
    assert PORT.split(".", 1)[0] not in common.FORBIDDEN_MODULES
    assert PORT.startswith("superresolution_tpu")


def test_reference_imports_nothing_of_the_port():
    files = sorted((common.BENCH_DIR / "reference").rglob("*.py"))
    assert files
    for f in files:
        assert PORT not in top_level_imports(f), f
    # and at run time: importing the reference loads no part of the port
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.models, portbench.reference.train, "
            "portbench.reference.compare, portbench.weights, "
            "portbench.traffic.generate; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{%r, 'jax', 'superresolution_tpu'}))"
            % (str(common.ROOT), PORT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
