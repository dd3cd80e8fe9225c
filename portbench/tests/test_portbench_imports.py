"""Nothing of the benchmark imports JAX, Flax or the JAX package, compared
by whole top-level module name (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""
import ast
import json
import re
import subprocess
import sys

from portbench.registry import ROOT
from portbench.run import FORBIDDEN, forbidden_modules

BENCH = ROOT / "portbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(FORBIDDEN), (path, tops & set(FORBIDDEN))
        assert not re.search(r"(?<![A-Za-z_])bench\.py", path.read_text()), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "math", "numpy", "torch"}, (path, tops)


def test_the_check_compares_whole_top_level_names():
    assert forbidden_modules(["recon3d_tpu_torch", "recon3d_tpu_torch.depth", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["recon3d_tpu", "recon3d_tpu.depth.sgm", "jax.numpy", "jaxlib",
                              "flax.linen", "torch"]) == sorted(
        ["recon3d_tpu", "recon3d_tpu.depth.sgm", "jax.numpy", "jaxlib", "flax.linen"])


def test_a_run_loads_no_jax_module():
    """Every module of the benchmark and the program modules its drivers
    load, imported in a fresh interpreter, bring in no JAX module."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from portbench.registry import Registry
from portbench import harness, control, trace, work, scenes, stereo_cells, fusion_cells, tap
from portbench.reference import stereo, tsdf
import recon3d_tpu_torch.depth.pipeline, recon3d_tpu_torch.parallel.batch
import recon3d_tpu_torch.parallel.fusion, recon3d_tpu_torch.pointcloud.backproject
reg = Registry()
for w in reg.bench["workloads"]:
    reg.driver(reg.cell(w["name"])["driver"])
for m in reg.bench["per_layer"]:
    reg.metric(m["name"])
from portbench.run import forbidden_modules
print(json.dumps(forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
