"""The structure of chip_smoke.py, read with `ast` on the CPU (the script
itself needs a card): its CPU references run in a pool of spawned worker
processes beside the card's phases (chip_smoke.RefPool), and these tests
guard what that must not cost.

  * main still calls every module function it called before the
    references moved into the pool (each phase, each kernel check);
  * the `timing:` line (each phase's wall and CPU-reference seconds) is
    printed before the final line, which stays the contract's
    {"ok": true, "device": ...};
  * no `except` in main or in the pool's pick-up (RefPool.result,
    finish, __exit__, run_ref) swallows a failure, and a job that raises
    fails its pick-up and the pool's context (run here: one spawned
    worker);
  * the pool's worker entry points (ref_worker_init, run_ref) and every
    job handed to the pool reach no CUDA-initialising call.
"""

import ast
import sys
from pathlib import Path

import pytest

import torch_threads  # noqa: F401 (the suite's torch thread cap)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402

SMOKE = ast.parse((REPO / 'chip_smoke.py').read_text())
# the module functions main called before this structure (each phase's
# entry point and each kernel check; the prints' helpers)
MAIN_CALLS = (
    'card_line', 'check', 'check_int8c_same_input', 'keep_freed_heap',
    'phase_data_parallel', 'phase_depth', 'phase_last_modules',
    'phase_megastep', 'phase_midas', 'phase_pcnet', 'phase_predictors',
    'phase_prep', 'phase_prep_f32', 'phase_prep_rgb', 'phase_prep_rgb_f32',
    'phase_stem_q8', 'phase_tester', 'phase_train', 'phase_trunk',
    'phase_trunk_bf16', 'phase_trunk_f32', 'phase_trunk_int8',
    'phase_trunk_v2_variants', 'phase_v2_f32_forwards')
# the pool's pick-up: where a job's failure reaches the main process
PICK_UP = ('RefPool.result', 'RefPool.finish', 'RefPool.__exit__', 'run_ref')
WORKER_ENTRY = ('ref_worker_init', 'run_ref')


def function(name):
    """The def of module function `name` or method `Class.name`."""
    scope, *rest = name.split('.')
    node = next(n for n in SMOKE.body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and n.name == scope)
    for part in rest:
        node = next(n for n in node.body
                    if isinstance(n, ast.FunctionDef) and n.name == part)
    return node


def called_names(node):
    return {n.func.id for n in ast.walk(node)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}


@pytest.mark.parametrize('name', MAIN_CALLS)
def test_main_still_calls(name):
    assert name in called_names(function('main'))


def prints(node):
    """The print(...) calls under node, in source order."""
    return sorted((n for n in ast.walk(node) if isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Name)
                   and n.func.id == 'print'), key=lambda n: n.lineno)


def test_timing_line_before_the_final_line():
    main = prints(function('main'))
    final = ast.unparse(main[-1])
    assert "'ok': True" in final and "'platform': 'gpu'" in final, final
    timing = [k for k, n in enumerate(main)
              if ast.unparse(n) == 'print(CLOCK.line())']
    assert len(timing) == 1 and timing[0] < len(main) - 1
    clock = CS.PhaseClock()
    clock.begin('a phase')
    with clock.ref('a reference'):
        pass
    clock.end()
    line = clock.line()
    assert line.startswith('timing: {') and '"a phase"' in line
    assert '"cpu_ref_s"' in line and '"wall_s"' in line


@pytest.mark.parametrize('name', ('main',) + PICK_UP)
def test_no_except_swallows_a_failure(name):
    node = function(name)
    for handler in (n for n in ast.walk(node)
                    if isinstance(n, ast.ExceptHandler)):
        assert any(isinstance(n, ast.Raise) for n in ast.walk(handler)), \
            f'{name}: an except at line {handler.lineno} does not re-raise'
    assert 'suppress' not in ast.unparse(node)
    returns = [n for n in ast.walk(node) if isinstance(n, ast.Return)
               and n.value is not None]
    assert name != 'RefPool.__exit__' or not returns, \
        '__exit__ returns a value: it could swallow the exception'


def test_a_failing_job_fails_its_pick_up_and_the_pool():
    with pytest.raises(RuntimeError, match='a failed reference'):
        with CS.RefPool(workers=1) as pool:
            pool.submit('ok', CS.host_tree, [1])
            assert pool.result('ok') == [1]
            pool.later('fails', CS.check, False, 'a failed reference',
                       then=lambda _: None)


def jobs():
    """Every function the script hands to the pool: the second argument
    of each .submit / .later / .result call that names one, and the
    *_REFS tables' jobs."""
    out = set()
    for n in ast.walk(SMOKE):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in ('submit', 'later', 'result')
                and len(n.args) >= 2 and isinstance(n.args[1], ast.Name)):
            out.add(n.args[1].id)
    defs = {n.name for n in SMOKE.body if isinstance(n, ast.FunctionDef)}
    tables = [CS.PCNET_REFS, CS.LEGACY_REFS, CS.dp_ref_job(CS.DP_WORLD),
              *CS.DEPTH_XDEV_REFS.values(), *CS.TRAIN_XDEV_REFS.values()]
    return sorted(out & defs | {job[1].__name__ for job in tables})


def cuda_calls(node):
    """The CUDA-reaching expressions under node: torch.cuda.* other than
    is_initialized, .cuda(), a 'cuda' device string, resolve_device."""
    allowed = {id(n.value) for n in ast.walk(node)
               if isinstance(n, ast.Attribute) and n.attr == 'is_initialized'}
    bad = [ast.unparse(n) for n in ast.walk(node)
           if isinstance(n, ast.Attribute) and n.attr == 'cuda'
           and id(n) not in allowed]
    bad += [n.value for n in ast.walk(node) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and n.value.startswith('cuda')]
    bad += [n.id for n in ast.walk(node) if isinstance(n, ast.Name)
            and n.id in ('resolve_device', '_build')]
    return bad


@pytest.mark.parametrize('name', WORKER_ENTRY)
def test_worker_entry_stays_off_the_card(name):
    assert not cuda_calls(function(name))


def test_jobs_stay_off_the_card():
    names = jobs()
    assert {'depth_xdev_cpu', 'train_xdev_cpu', 'pcnet_cpu', 'legacy_cpu',
            'dp_reference_cpu', 'predictor_cpu', 'tester_cpu',
            'midas_forward_cpu', 'midas_tester_cpu',
            'test_disp_cpu'} <= set(names), names
    for name in names:
        assert not cuda_calls(function(name)), name
