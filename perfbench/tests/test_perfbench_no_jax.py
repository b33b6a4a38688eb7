"""Nothing that the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""
import ast
import subprocess
import sys

from perfbench import run

DRIVE = """
import sys, json, glob, os
sys.path.insert(0, {root!r})
from perfbench import run, compare, trace, readings  # noqa
from perfbench.gen import speckle  # noqa
for kind in ("gen", "entries", "layer_metrics", "end_to_end"):
    for path in sorted(glob.glob(os.path.join({root!r}, "perfbench", kind, "[!_]*.py"))):
        run.load_module(kind, os.path.basename(path)[:-3])
line = run.run_cell("speckle_2k.stack100", 5, 0.0, True, "cpu",
                    overrides={{"detector": {{"height": 384, "width": 384}},
                               "traffic": {{"frames": 5, "pool": 1, "warmup_calls": 1}}}})
print(json.dumps({{"forbidden": run.forbidden_modules(), "port": "barc4dip_tpu_torch" in sys.modules,
                  "correct": line["correct"]}}))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", DRIVE.format(root=str(run.ROOT))], capture_output=True,
                          text=True, timeout=600, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()[-1]
    assert out == '{"forbidden": [], "port": true, "correct": true}'


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in [n for n in sys.modules if n.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "barc4dip_tpu_torch.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    monkeypatch.setitem(sys.modules, "barc4dip_tpu.ops", sys)
    assert run.forbidden_modules() == ["barc4dip_tpu", "jaxlib"]


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((run.BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("barc4dip_tpu_torch",) + run.FORBIDDEN for n in names), path
    code = (f"import sys; sys.path.insert(0, {str(run.ROOT)!r}); "
            "import perfbench.reference.speckle, perfbench.reference.sharpness, perfbench.reference.tracking; "
            "print(sorted(n for n in sys.modules if n.split('.')[0].startswith('barc4dip')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr[-2000:]
