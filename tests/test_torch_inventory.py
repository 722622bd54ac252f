"""The port's completeness, read statically from the sources.

Every function of the JAX package that reaches `pl.pallas_call` (found
with `ast`, not by name) must be a key of the port's kernel inventory
(`instaorder_tpu_torch/ops/inventory.py`), whose wrappers and plain
versions import without JAX and whose rows name every CUDA source; every
public top-level def and class of each JAX module must have an object of
the same name in the port module of the same path, be a Pallas function
of the inventory, or be listed in `inventory.NOT_IN_PORT` with what the
port has instead. A planted source shows that the scan reports both
kinds of gap, and `inventory.missing_rows` (the smoke's coverage check)
reports a row the smoke did not hold.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

import torch_threads  # noqa: F401 (the suite's torch thread cap)
from instaorder_tpu_torch.ops import inventory

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / 'instaorder_tpu'
PORT_PKG = REPO / 'instaorder_tpu_torch'
# the Pallas sites of the JAX package (PERF.md section 6)
N_FUNCTIONS, N_SITES = 21, 23
KINDS = ('moved', 'replaced', 'not copied')


def jax_sources():
    """{path under instaorder_tpu/: source} of every JAX module."""
    return {p.relative_to(JAX_PKG).as_posix(): p.read_text()
            for p in sorted(JAX_PKG.rglob('*.py'))}


def _calls_pallas(node):
    f = node.func
    return isinstance(node, ast.Call) and (
        isinstance(f, ast.Attribute) and f.attr == 'pallas_call'
        or isinstance(f, ast.Name) and f.id == 'pallas_call')


def pallas_functions(sources):
    """{top-level name: (path, first line, last line, [site lines])} of
    each top-level def or class whose body calls pallas_call; a site
    outside any def is reported under '<module path>'."""
    found = {}
    for path, src in sources.items():
        tree = ast.parse(src)
        for top in tree.body:
            sites = [n.lineno for n in ast.walk(top)
                     if isinstance(n, ast.Call) and _calls_pallas(n)]
            if not sites:
                continue
            name = getattr(top, 'name', f'<{path}>')
            found[name] = (path, top.lineno, top.end_lineno, sites)
    return found


def public_names(src):
    """The public top-level def and class names of a module's source."""
    return [n.name for n in ast.parse(src).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith('_')]


def port_module(path):
    """The port module of the same path, or None where it has none."""
    if not (PORT_PKG / path).exists():
        return None
    parts = Path(path).with_suffix('').parts
    if parts[-1] == '__init__':
        parts = parts[:-1]
    return importlib.import_module('.'.join(('instaorder_tpu_torch',)
                                            + parts))


def unexplained(path, src, module, kernels, not_in_port):
    """The public names of JAX module `path` that the port neither
    defines in `module` nor has as an inventory kernel nor lists."""
    listed = not_in_port.get(path, {})
    return [n for n in public_names(src)
            if not (module is not None and hasattr(module, n))
            and n not in kernels and n not in listed]


def resolve(target):
    """'module:name' -> the object it names."""
    mod, name = target.split(':')
    return getattr(importlib.import_module(mod), name)


def test_pallas_scan_matches_inventory():
    """The scanned Pallas functions are exactly the inventory's keys, at
    the lines the inventory and the smoke's `replaces` give."""
    found = pallas_functions(jax_sources())
    assert len(found) == N_FUNCTIONS, sorted(found)
    assert sum(len(f[3]) for f in found.values()) == N_SITES
    assert {f[0] for f in found.values()} == {'ops/pallas_blocks.py',
                                              'ops/prep_pallas.py'}
    assert set(found) == set(inventory.KERNELS)
    for name, k in inventory.KERNELS.items():
        path, first, last, _ = found[name]
        assert k.jax == f'instaorder_tpu/{path}:{first}', name
        for row, (_, at) in k.rows.items():
            file, line = at.rsplit(':', 1)
            assert file == f'instaorder_tpu/{path}', row
            assert first <= int(line) <= last, (row, at)


def test_inventory_rows_and_sources():
    """40 rows, each on a CUDA source of the port; every csrc/*.cu file
    is some row's source."""
    rows = inventory.rows()
    assert len(rows) == 40
    sources = {src for src, _ in rows.values()}
    for src in sources:
        assert (REPO / src).is_file(), src
    assert sources == {f'instaorder_tpu_torch/csrc/{p.name}'
                       for p in (PORT_PKG / 'csrc').glob('*.cu')}


def test_inventory_functions_import_without_jax():
    """Every wrapper and plain version the inventory names imports on the
    CPU with jax and the JAX package blocked; the inventory itself
    imports neither torch nor a kernel module."""
    names = sorted({(k.module, f) for k in inventory.KERNELS.values()
                    for f in (k.kernel, k.plain)})
    code = ('import sys; sys.modules["jax"] = None; '
            'sys.modules["instaorder_tpu"] = None; import importlib\n'
            'from instaorder_tpu_torch.ops import inventory\n'
            'assert "torch" not in sys.modules\n'
            f'for m, f in {names!r}:\n'
            '    assert callable(getattr(importlib.import_module(m), f)), f\n'
            'bad = [m for m in sys.modules if m == "jax" and sys.modules[m] '
            'is not None or m.startswith(("jax.", "instaorder_tpu."))]\n'
            'assert not bad, bad\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_smoke_wrappers_match_inventory():
    """The wrapper that chip_smoke.py counts for each row is the one the
    inventory names for that row's JAX function."""
    import chip_smoke
    main = next(n for n in ast.parse((REPO / 'chip_smoke.py').read_text())
                .body if getattr(n, 'name', None) == 'main')
    alias = {a.asname or a.name: f'{n.module}.{a.name}'
             for n in ast.walk(main) if isinstance(n, ast.ImportFrom)
             for a in n.names}
    table = next(n.value for n in ast.walk(main)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], 'id', None) == 'wrappers')
    by_row = {row: name for name, k in inventory.KERNELS.items()
              for row in k.rows}
    seen = set()
    for key, val in zip(table.keys, table.values):
        name = by_row[getattr(chip_smoke, key.id)]
        k = inventory.KERNELS[name]
        assert (alias[val.value.id], val.attr) == (k.module, k.kernel), name
        seen.add(name)
    assert seen == set(inventory.KERNELS)


@pytest.mark.parametrize('path', sorted(jax_sources()))
def test_public_names_have_counterparts(path):
    """Each public top-level def and class of the JAX module has its
    counterpart: the same name in the port module of the same path, an
    inventory kernel, or a listed reason."""
    src = (JAX_PKG / path).read_text()
    module = port_module(path)
    assert module is not None or path in ('ops/pallas_blocks.py',
                                          'ops/prep_pallas.py'), path
    assert unexplained(path, src, module, inventory.KERNELS,
                       inventory.NOT_IN_PORT) == []
    if module is None:          # its Pallas functions live in the inventory
        kernels = [n for n in public_names(src)
                   if n not in inventory.NOT_IN_PORT.get(path, {})]
        assert all(inventory.KERNELS[n].jax.startswith(
            f'instaorder_tpu/{path}:') for n in kernels)


def test_not_in_port_entries_hold():
    """Each listed name is a public JAX name that the port really lacks,
    with a one-line reason of a known kind; 'moved' and 'replaced' name
    a port object that exists."""
    for path, names in inventory.NOT_IN_PORT.items():
        src = (JAX_PKG / path).read_text()
        module = port_module(path)
        for name, (kind, what) in names.items():
            assert name in public_names(src), (path, name)
            assert module is None or not hasattr(module, name), (path, name)
            assert kind in KINDS and what and '\n' not in what, (path, name)
            if kind != 'not copied':
                assert callable(resolve(what)), what


PLANTED = '''
from jax.experimental import pallas as pl


def fused_planted(x):
    return pl.pallas_call(lambda r, o: None, out_shape=x)(x)


def planted_helper(x):
    return x
'''


def test_scan_reports_planted_gaps():
    """A source with one more pallas_call function and one more public
    def than the port has: the scan reports both."""
    sources = jax_sources()
    path = 'core/schedule.py'
    sources[path] += PLANTED
    found = pallas_functions(sources)
    assert set(found) - set(inventory.KERNELS) == {'fused_planted'}
    assert sum(len(f[3]) for f in found.values()) == N_SITES + 1
    assert unexplained(path, sources[path], port_module(path),
                       inventory.KERNELS, inventory.NOT_IN_PORT) == [
        'fused_planted', 'planted_helper']
    # a module the port lacks altogether reports every public name
    assert unexplained('ops/planted.py', PLANTED, None, inventory.KERNELS,
                       inventory.NOT_IN_PORT) == [
        'fused_planted', 'planted_helper']


def test_coverage_reports_a_missing_row():
    """The smoke's coverage check: a list of held rows lacking one row of
    the inventory reports exactly that row, and the line names it."""
    rows = list(inventory.rows())
    assert inventory.missing_rows(rows) == []
    assert inventory.coverage_line(rows).endswith('missing: none')
    for drop in (rows[0], 'fused_stem[q8][f32]', rows[-1]):
        held = [r for r in rows if r != drop]
        assert inventory.missing_rows(held) == [drop]
        line = inventory.coverage_line(held + ['not a row'])
        assert line.endswith(f'missing: {drop}'), line
        assert line.startswith('inventory coverage: 39 of 40 '), line
