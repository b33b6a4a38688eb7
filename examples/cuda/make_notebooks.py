# SPDX-License-Identifier: CECILL-2.1
"""Render the port's example scripts as Jupyter notebooks
(examples/cuda/notebooks/).

The scripts ``examples/cuda/ex_*.py`` stay the source; each notebook is
derived from one, so the two cannot drift apart. A notebook holds the
script's docstring as a markdown header, a setup cell (the repo made
importable from the working directory, and ``DEVICE = None``: the card;
``"cpu"`` runs without one), the script's body without its ``__main__``
guard as one code cell, and a run cell that calls ``main`` with an output
directory beside the notebook and ``device=DEVICE``. Cell ids are derived
from the script's name, so a render is the same on every run.

Usage, after any change to a script:
    python examples/cuda/make_notebooks.py
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

import nbformat as nbf

HERE = Path(__file__).resolve().parent
OUT = HERE / "notebooks"

SETUP_CELL = '''\
# make the repo importable from wherever this notebook is opened
import os
import sys
from pathlib import Path

root = Path(os.environ.get("BARC4DIP_TORCH_ROOT", Path.cwd()))
while not (root / "barc4dip_tpu_torch").is_dir() and root != root.parent:
    root = root.parent
sys.path.insert(0, str(root))

DEVICE = None  # the card; "cpu" runs without one
'''


def _is_main_guard(node: ast.stmt) -> bool:
    return (
        isinstance(node, ast.If)
        and isinstance(node.test, ast.Compare)
        and isinstance(node.test.left, ast.Name)
        and node.test.left.id == "__name__"
    )


def _is_file_path_insert(node: ast.stmt) -> bool:
    """The scripts' ``sys.path.insert(0, ...__file__...)`` line: a kernel
    has no ``__file__``, and the setup cell does its work."""
    if not (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)):
        return False
    text = ast.unparse(node.value)
    return "__file__" in text and "sys.path" in text


def split_script(source: str) -> tuple[str, str]:
    """(docstring, body): the body is the script's text without its
    docstring (and the comment lines above it), the ``sys.path`` line and
    the ``__main__`` guard, with runs of blank lines cut to two."""
    tree = ast.parse(source)
    doc = ast.get_docstring(tree) or ""
    drop: set[int] = set()  # 0-based line numbers
    for node in tree.body:
        is_doc = node is tree.body[0] and isinstance(node, ast.Expr) and isinstance(
            node.value, ast.Constant) and isinstance(node.value.value, str)
        if is_doc:
            drop.update(range(0, node.end_lineno))
        elif _is_main_guard(node) or _is_file_path_insert(node):
            drop.update(range(node.lineno - 1, node.end_lineno))
    lines = [line for i, line in enumerate(source.splitlines()) if i not in drop]
    body = re.sub(r"\n{4,}", "\n\n\n", "\n".join(lines)).strip("\n")
    return doc, body + "\n"


def build_notebook(script: Path) -> nbf.NotebookNode:
    doc, body = split_script(script.read_text())
    title = script.stem
    run_cell = (
        f'out_dir = "{title}_output"\n'
        "os.makedirs(out_dir, exist_ok=True)\n"
        "main(out_dir, device=DEVICE)\n"
    )
    nb = nbf.v4.new_notebook()
    nb.metadata["kernelspec"] = {"display_name": "Python 3", "language": "python", "name": "python3"}
    nb.cells = [
        nbf.v4.new_markdown_cell(f"# {title}\n\n{doc}"),
        nbf.v4.new_code_cell(SETUP_CELL),
        nbf.v4.new_code_cell(body),
        nbf.v4.new_code_cell(run_cell),
    ]
    for i, cell in enumerate(nb.cells):
        cell["id"] = f"{title[:5]}-{i}"
    return nb


def render(script: Path) -> str:
    """The notebook file's text for ``script``."""
    text = nbf.writes(build_notebook(script))
    return text if text.endswith("\n") else text + "\n"


def main() -> int:
    OUT.mkdir(exist_ok=True)
    for script in sorted(HERE.glob("ex_*.py")):
        dest = OUT / f"{script.stem}.ipynb"
        dest.write_text(render(script))
        print(f"wrote {dest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
