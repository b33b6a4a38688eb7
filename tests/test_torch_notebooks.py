# SPDX-License-Identifier: CECILL-2.1
"""The notebooks of the port's examples (``examples/cuda/notebooks``) are
renders of their scripts by ``examples/cuda/make_notebooks.py``: each
committed notebook equals a fresh render, its code cell holds the script's
body, no cell names ``__file__``, jax or the JAX package, and one notebook
runs in a real kernel on the CPU."""
import ast
import importlib.util
import re
from pathlib import Path

import nbformat
import pytest

CUDA = Path(__file__).resolve().parents[1] / "examples" / "cuda"
SCRIPTS = sorted(CUDA.glob("ex_*.py"))

_spec = importlib.util.spec_from_file_location("cuda_make_notebooks", CUDA / "make_notebooks.py")
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)


def test_one_notebook_a_script():
    assert len(SCRIPTS) == 8
    assert sorted(p.stem for p in (CUDA / "notebooks").glob("*.ipynb")) == [p.stem for p in SCRIPTS]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda p: p.stem)
def test_committed_notebook_is_a_fresh_render(script):
    committed = CUDA / "notebooks" / f"{script.stem}.ipynb"
    assert committed.read_text() == mk.render(script)
    nb = nbformat.read(committed, as_version=4)
    nbformat.validate(nb)
    assert [c.cell_type for c in nb.cells] == ["markdown", "code", "code", "code"]


def _script_body(source: str) -> ast.Module:
    """The script's statements but its docstring, its ``sys.path`` line and
    its ``__main__`` guard."""
    tree = ast.parse(source)
    keep = []
    for i, node in enumerate(tree.body):
        text = ast.unparse(node)
        if i == 0 and isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            continue
        if text.startswith("if __name__ ==") or ("sys.path" in text and "__file__" in text):
            continue
        keep.append(node)
    return ast.Module(body=keep, type_ignores=[])


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda p: p.stem)
def test_code_cell_holds_the_scripts_body(script):
    source = script.read_text()
    nb = nbformat.read(CUDA / "notebooks" / f"{script.stem}.ipynb", as_version=4)
    doc, setup, body, run = nb.cells
    assert ast.dump(ast.parse(body.source)) == ast.dump(_script_body(source))
    assert ast.get_docstring(ast.parse(source)) in doc.source
    assert "DEVICE = None" in setup.source
    assert run.source.rstrip().endswith("main(out_dir, device=DEVICE)")
    # the comments of the body stay, as in the script
    comments = [line.strip() for line in body.source.splitlines() if line.strip().startswith("#")]
    assert all(c in source for c in comments)


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda p: p.stem)
def test_no_cell_names_file_or_jax(script):
    nb = nbformat.read(CUDA / "notebooks" / f"{script.stem}.ipynb", as_version=4)
    for cell in nb.cells:
        assert "__file__" not in cell.source
        assert not re.search(r"\bjax\b", cell.source), cell.source
        assert "barc4dip_tpu." not in cell.source
        assert not re.search(r"import barc4dip_tpu\b(?!_)", cell.source)


def test_notebook_runs_in_a_kernel_on_the_cpu(tmp_path):
    """ex_03 at its smoke-test size with ``DEVICE = "cpu"``, in a real
    kernel started from another directory (about 11 s)."""
    from nbclient import NotebookClient

    nb = mk.build_notebook(CUDA / "ex_03_fourier_analysis.py")
    nb.cells.insert(0, nbformat.v4.new_code_cell(
        "import os\n"
        "os.environ['BARC4DIP_EX_FAST'] = '1'\n"
        f"os.environ['BARC4DIP_TORCH_ROOT'] = {str(CUDA.parents[1])!r}\n"
    ))
    nb.cells.insert(3, nbformat.v4.new_code_cell('DEVICE = "cpu"\n'))
    NotebookClient(nb, timeout=300, resources={"metadata": {"path": str(tmp_path)}}).execute()
    printed = "".join(
        out.get("text", "") for cell in nb.cells if cell.cell_type == "code"
        for out in cell.get("outputs", []) if out.get("name") == "stdout"
    )
    assert "scan radial profiles: (4, " in printed
    assert (tmp_path / "ex_03_fourier_analysis_output" / "ex03_psd.png").exists()
