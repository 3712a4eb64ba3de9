"""The port's quick-demo notebooks (``clair3_tpu_torch/notebooks/``, written
by ``python -m clair3_tpu_torch.build_notebooks``), the twin of
``tests/test_notebooks.py``: they are checked in *executed*, each embeds its
acceptance table, and these tests pin that the artifacts stay valid,
executed and passing without re-running them."""

import glob
import os

import nbformat
import pytest

NB_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "clair3_tpu_torch", "notebooks")
NOTEBOOKS = sorted(glob.glob(os.path.join(NB_DIR, "*.ipynb")))


def test_all_four_notebooks_exist():
    names = {os.path.basename(p) for p in NOTEBOOKS}
    assert {
        "clair3_tpu_torch_ont_quick_demo.ipynb",
        "clair3_tpu_torch_pacbio_hifi_quick_demo.ipynb",
        "clair3_tpu_torch_illumina_quick_demo.ipynb",
        "clair3_tpu_torch_quick_demo.ipynb",
    } <= names


@pytest.mark.parametrize("path", NOTEBOOKS, ids=os.path.basename)
def test_notebook_executed_and_acceptance_passed(path):
    nb = nbformat.read(path, as_version=4)
    nbformat.validate(nb)
    code_cells = [c for c in nb.cells if c.cell_type == "code"]
    assert code_cells, "notebook has no code cells"
    # every code cell was executed in order
    counts = [c.get("execution_count") for c in code_cells]
    assert all(isinstance(c, int) for c in counts), "unexecuted cell"
    assert counts == sorted(counts)
    # no error outputs anywhere
    for c in code_cells:
        for o in c.get("outputs", []):
            assert o.get("output_type") != "error", o.get("evalue")
    # the scoring cell printed its acceptance verdict
    text = "".join(
        o.get("text", "")
        for c in code_cells for o in c.get("outputs", []))
    assert "acceptance: PASS" in text
    assert "F1-score" in text
    # the port's modules only, and the device it ran on named
    source = "".join(c.source for c in code_cells)
    assert "clair3_tpu_torch" in source and "from clair3_tpu." not in source
    assert "DEVICE = " in source
