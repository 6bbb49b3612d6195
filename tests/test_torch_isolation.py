"""The port and its chip check import nothing of JAX.

An AST scan of every module under synapseml_torch/ and of chip_smoke.py:
no import of jax, flax, optax or synapseml_tpu, at any depth of the file
(a sys.modules check cannot work here: the test process has JAX loaded).
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "synapseml_tpu"}
FILES = sorted((ROOT / "synapseml_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            roots.add(node.args[0].value.split(".")[0])
    return roots


def test_the_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "synapseml_torch/ops/attention.py",
            "synapseml_torch/models/text.py", "synapseml_torch/gbdt/trees.py",
            "synapseml_torch/gbdt/hist.py", "synapseml_torch/models/trainer.py",
            "synapseml_torch/data/loader.py", "synapseml_torch/onnx/proto.py",
            "synapseml_torch/onnx/convert.py", "synapseml_torch/onnx/model.py",
            "synapseml_torch/onnx/hub.py", "synapseml_torch/onnx/featurizer.py",
            "synapseml_torch/models/vision.py", "synapseml_torch/models/nets/vit.py",
            "synapseml_torch/models/nets/resnet.py", "synapseml_torch/image/transforms.py",
            "synapseml_torch/image/unroll.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN)


def test_the_scan_sees_nested_and_dynamic_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from flax import linen\n"
                   "import importlib\nimportlib.import_module('synapseml_tpu.ops')\n")
    assert {"flax", "synapseml_tpu"} <= _imported_roots(src)
