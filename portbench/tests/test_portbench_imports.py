"""The import scan: no file of the benchmark imports JAX or the JAX
package, and the reference imports nothing of the program, top-level
module names compared whole (the port's name begins with the JAX
package's)."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'instaorder_tpu'}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def test_scan_compares_whole_names(tmp_path):
    p = tmp_path / 'x.py'
    p.write_text('import instaorder_tpu_torch.serving\n'
                 'from instaorder_tpu.models import resnet\n')
    assert top_level_imports(p) == {'instaorder_tpu_torch', 'instaorder_tpu'}
    assert top_level_imports(p) & FORBIDDEN == {'instaorder_tpu'}


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob('*.py'))
    assert len(files) > 20
    for f in files:
        assert not top_level_imports(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / 'reference').rglob('*.py')):
        assert 'instaorder_tpu_torch' not in top_level_imports(f), f
    code = ('import sys; sys.path.insert(0, %r); '
            'import portbench.reference.model, portbench.reference.prep, '
            'portbench.reference.train, portbench.reference.macs; '
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"instaorder_tpu_torch", "instaorder_tpu", "jax", "flax"}))'
            % str(HERE.parent))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == '[]'


def test_harness_reports_loaded_jax(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, 'instaorder_tpu', object())
    assert harness.forbidden_modules() == ['instaorder_tpu']
    monkeypatch.delitem(sys.modules, 'instaorder_tpu')
    monkeypatch.setitem(sys.modules, 'instaorder_tpu_torch_x', object())
    assert 'instaorder_tpu' not in harness.forbidden_modules()
