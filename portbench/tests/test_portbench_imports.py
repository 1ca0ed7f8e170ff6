"""No module the benchmark runs imports JAX, its libraries or the JAX
package (the top-level name compared whole: ``ircolor_tpu_torch`` is the
program, ``ircolor_tpu`` is not), and the reference imports nothing of the
program."""

import ast
import subprocess
import sys

from portbench.run import FORBIDDEN, HERE, ROOT


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_forbidden_import_in_the_sources():
    for path in HERE.rglob("*.py"):
        assert not set(_imports(path)) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        tops = set(_imports(path))
        assert tops <= {"__future__", "torch", "math", "portbench"}, (path, tops)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), (path, node.module)


def test_a_run_loads_no_forbidden_module():
    code = ("import portbench.run as r, portbench.cells, portbench.calibrate, portbench.flops\n"
            "from ircolor_tpu_torch.eval.runner import make_infer_fn\n"
            "from ircolor_tpu_torch.train.state import create_train_state\n"
            "from ircolor_tpu_torch.train.step import make_train_step\n"
            "from ircolor_tpu_torch.losses.vgg import VGG16Features\n"
            "from ircolor_tpu_torch.models.wrapper import IRColorizationModel\n"
            "spec = {}\n"
            "for name in ('flagship-serve-int8-b32', 'flagship-train-b8', 'ref256-serve-int8-b32'):\n"
            "    spec[name] = r.load_cell(name)\n"
            "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
