"""Nothing the harness runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port: read from
every file's imports, and from ``sys.modules`` after a run of each cell
at the tiny sizes in a fresh process."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.run import FORBIDDEN, ROOT

PORT = 'mmdet3d_gaussian_tpu_torch'
HERE = ROOT / 'portbench'

DRY_RUN = r'''
import json, sys, torch
from portbench.run import run_cell
from portbench.tests import tiny
run_cell('pp_kitti_train', 3, 0.2, 1, torch.device('cpu'),
         cfg=tiny.pp_config(), traffic_over=tiny.PP_TRAFFIC)
run_cell('centerpoint_nus_predict', 3, 0.2, 1, torch.device('cpu'),
         cfg=tiny.cp_config(), traffic_over=tiny.CP_TRAFFIC)
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
'''


def imported(path: Path):
    """Top-level names of every module a file imports (absolute)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split('.')[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith('mmdet3d_gaussian_tpu') \
                and '.' in node.value:
            # a dotted module path that importlib loads by name
            out.add(node.value.split('.')[0])
    return out


def harness_files():
    return [p for p in HERE.rglob('*.py') if 'tests' not in p.parts]


def test_no_file_imports_jax():
    for path in harness_files():
        assert not imported(path) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    for path in (HERE / 'reference').rglob('*.py'):
        names = imported(path)
        assert PORT not in names and not names & set(FORBIDDEN), path


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, '-c', DRY_RUN], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded and 'portbench' in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
