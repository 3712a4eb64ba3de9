"""No file of the port, and neither ``chip_smoke.py`` nor
``run_clair3_tpu_torch.py``, imports the JAX package.

Every ``.py`` file under ``clair3_tpu_torch/``, ``chip_smoke.py`` and
``run_clair3_tpu_torch.py`` is parsed with ``ast``.  An ``import clair3_tpu``, ``import clair3_tpu.x``,
``from clair3_tpu import ...`` or ``from clair3_tpu.x import ...`` fails, and
so does a path built from ``clair3_tpu.__file__``.  ``clair3_tpu_torch``
is another name and passes.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "run_clair3_tpu_torch.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "clair3_tpu_torch")):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("__pycache__", "_kernels")))
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return [os.path.relpath(p, REPO) for p in out]


def _is_jax_package(name) -> bool:
    return name is not None and name.split(".")[0] == "clair3_tpu"


def jax_package_uses(source: str):
    """(line, what) for every import of ``clair3_tpu`` and every
    ``clair3_tpu.__file__`` in ``source``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, f"import {a.name}") for a in node.names
                      if _is_jax_package(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _is_jax_package(node.module):
            found.append((node.lineno, f"from {node.module} import ..."))
        elif (isinstance(node, ast.Attribute) and node.attr == "__file__"
              and isinstance(node.value, ast.Name) and node.value.id == "clair3_tpu"):
            found.append((node.lineno, "clair3_tpu.__file__"))
    return found


@pytest.mark.parametrize("rel", _port_files())
def test_file_does_not_use_the_jax_package(rel):
    with open(os.path.join(REPO, rel)) as fh:
        uses = jax_package_uses(fh.read())
    assert not uses, f"{rel}: {uses}"


def test_every_port_module_is_checked():
    files = set(_port_files())
    for rel in ("serve.py", "models/convert.py", "models/schema.py", "models/params_io.py",
                "cli.py", "device.py", "models/init.py", "full_cascade_demo.py", "train/__init__.py",
                "train/data.py", "train/unify.py", "train/loss.py", "train/step.py",
                "train/trainer.py", "compat.py", "gvcf_validate.py",
                "parallel/distributed.py", "parallel/mesh.py", "pipeline/call.py",
                "wgs_scale_demo.py", "train_fixture_checkpoints.py", "quick_demo.py",
                "visualize_tensor.py", "models/fb.py", "bench.py", "bench_fa_conv1.py",
                "bench_history.py", "graft_entry.py", "build_notebooks.py"):
        assert os.path.join("clair3_tpu_torch", rel) in files, rel


@pytest.mark.parametrize("source,n", [
    ("import clair3_tpu\n", 1),
    ("import clair3_tpu.native as n\n", 1),
    ("from clair3_tpu import testing\n", 1),
    ("from clair3_tpu.io.bam import BamReader\n", 1),
    ("def f():\n    import os, clair3_tpu\n    return os.path.dirname(clair3_tpu.__file__)\n", 2),
    ("import clair3_tpu_torch\nfrom clair3_tpu_torch.io import bam\nfrom . import x\n", 0),
])
def test_the_check_finds_what_it_should(source, n):
    assert len(jax_package_uses(source)) == n
