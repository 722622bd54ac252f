"""The port's kernels and what the JAX package has that the port does
not, as strings: nothing here imports torch or a kernel module, so
`chip_smoke.py` and the CPU tests read it anywhere.

`KERNELS` maps each JAX function that reaches `pl.pallas_call` to its
port: the wrapper module, the wrapper that launches the CUDA kernel on a
CUDA tensor, the plain PyTorch version it runs on a CPU tensor, and the
rows of `chip_smoke.py`'s `kernels` line that hold it against that plain
version on the card (a row per mode: `[f32]`, `[q8]`, `[down=False]`),
each with its CUDA source and the JAX line it replaces.

`NOT_IN_PORT` lists the public top-level names of the JAX modules that
the port module of the same path does not define, each with what the
port has instead: ('moved', 'module:name'), ('replaced', 'module:name')
or ('not copied', reason).
"""

from typing import NamedTuple

_CSRC = 'instaorder_tpu_torch/csrc/'
PREP_CU = _CSRC + 'prep.cu'
V2_CU = _CSRC + 'bottleneck_v2.cu'
F32_CU = _CSRC + 'bottleneck_f32.cu'
INT8_CU = _CSRC + 'bottleneck_int8.cu'
STEM_CU = _CSRC + 'stem.cu'
_PB = 'instaorder_tpu/ops/pallas_blocks.py'
_PP = 'instaorder_tpu/ops/prep_pallas.py'
_OPS = 'instaorder_tpu_torch.ops.'
_PK = _OPS + 'prep_kernels'
_BK = _OPS + 'bottleneck_kernels'
_B16 = _OPS + 'bottleneck_bf16_kernels'
_IK = _OPS + 'int8_kernels'
_SK = _OPS + 'stem_kernels'


class Kernel(NamedTuple):
    jax: str            # 'file:line' of the JAX function's def
    module: str         # the port's wrapper module
    kernel: str         # the wrapper: the CUDA kernel on a CUDA tensor
    plain: str          # the plain version, which it runs on a CPU tensor
    rows: dict          # chip_smoke row -> (CUDA source, 'file:line')


def _kernel(jax, module, kernel, plain, rows, at=()):
    """rows: {row: CUDA source}; each row replaces the JAX def at `jax`,
    but those that `at` gives another line of the same function."""
    at = dict(at)
    return Kernel(jax, module, kernel, plain,
                  {r: (src, at.get(r, jax)) for r, src in rows.items()})


def _v2(jax, kernel, plain, row, modes=('',)):
    """A v2 block kernel: each mode's row on bottleneck_v2.cu and its f32
    mode's (compute_dtype=f32) on bottleneck_f32.cu."""
    rows = {}
    for m in modes:
        rows[row + m] = V2_CU
        rows[row + m + '[f32]'] = F32_CU
    return _kernel(jax, _BK, kernel, plain, rows)


def _bf16(jax, kernel, row):
    """A bf16 block kernel and its f32 mode (--dtype f32)."""
    return _kernel(jax, _B16, kernel, kernel + '_plain',
                   {row: V2_CU, row + '[f32]': F32_CU})


KERNELS = {
    'fused_prep_pairs': _kernel(
        _PP + ':315', _PK, 'fused_prep_pairs', 'fused_prep_pairs_plain',
        {'fused_prep_pairs': PREP_CU, 'fused_prep_pairs[f32]': PREP_CU},
        at={'fused_prep_pairs[f32]': _PP + ':316'}),
    'fused_prep_rgb': _kernel(
        _PP + ':200', _PK, 'fused_prep_rgb', 'fused_prep_rgb_plain',
        {'fused_prep_rgb': PREP_CU, 'fused_prep_rgb[f32]': PREP_CU}),
    'fused_bottleneck_i8v2_hwnc_stage': _v2(
        _PB + ':1526', 'fused_bottleneck_i8v2_stage',
        'fused_bottleneck_i8v2_stage_plain',
        'fused_bottleneck_i8v2_hwnc_stage', modes=('', '[down=False]')),
    'fused_bottleneck_down_s2_i8v2_hwnc': _v2(
        _PB + ':1010', 'fused_bottleneck_i8v2_down_s2',
        'fused_bottleneck_i8v2_down_s2_plain',
        'fused_bottleneck_down_s2_i8v2_hwnc'),
    'fused_bottleneck_i8v2_hwnc': _v2(
        _PB + ':739', 'fused_bottleneck_i8v2_identity',
        'fused_bottleneck_i8v2_identity_plain', 'fused_bottleneck_i8v2_hwnc'),
    'fused_bottleneck_i8v2_hwncp_stage': _v2(
        _PB + ':1787', 'fused_bottleneck_i8v2_hwncp_stage',
        'fused_bottleneck_i8v2_hwncp_stage_plain',
        'fused_bottleneck_i8v2_hwncp_stage'),
    'fused_bottleneck_down_i8v2_hwnc': _v2(
        _PB + ':872', 'fused_bottleneck_down_i8v2_hwnc',
        'fused_bottleneck_down_i8v2_hwnc_plain',
        'fused_bottleneck_down_i8v2_hwnc'),
    'fused_bottleneck_i8v2': _v2(
        _PB + ':551', 'fused_bottleneck_i8v2', 'fused_bottleneck_i8v2_plain',
        'fused_bottleneck_i8v2'),
    'fused_bottleneck_down_i8v2': _v2(
        _PB + ':633', 'fused_bottleneck_down_i8v2',
        'fused_bottleneck_down_i8v2_plain', 'fused_bottleneck_down_i8v2'),
    'fused_bottleneck': _bf16(_PB + ':86', 'fused_bottleneck',
                              'fused_bottleneck'),
    'fused_bottleneck_stage': _bf16(_PB + ':172', 'fused_bottleneck_stage',
                                    'fused_bottleneck_stage'),
    'fused_bottleneck_stage_stream': _bf16(
        _PB + ':259', 'fused_bottleneck_stage_stream',
        'fused_bottleneck_stage_stream'),
    'fused_bottleneck_down': _bf16(_PB + ':1974', 'fused_bottleneck_down',
                                   'fused_bottleneck_down'),
    'fused_bottleneck_hwnc': _bf16(_PB + ':2439', 'fused_bottleneck_hwnc',
                                   'fused_bottleneck_hwnc'),
    'fused_stem': _kernel(
        _PB + ':2271', _SK, 'fused_stem', 'fused_stem_plain',
        {'fused_stem': STEM_CU, 'fused_stem[f32]': STEM_CU,
         'fused_stem[q8]': STEM_CU, 'fused_stem[q8][f32]': STEM_CU}),
    'fused_bottleneck_int8': _kernel(
        _PB + ':460', _IK, 'fused_bottleneck_int8',
        'fused_bottleneck_int8_plain', {'fused_bottleneck_int8': INT8_CU}),
    'fused_bottleneck_down_int8': _kernel(
        _PB + ':2122', _IK, 'fused_bottleneck_down_int8',
        'fused_bottleneck_down_int8_plain',
        {'fused_bottleneck_down_int8': INT8_CU}),
    'fused_stem_int8': _kernel(
        _PB + ':2354', _SK, 'fused_stem_int8', 'fused_stem_int8_plain',
        {'fused_stem_int8': STEM_CU}),
    'fused_bottleneck_int8_hwnc': _kernel(
        _PB + ':1134', _IK, 'fused_bottleneck_int8_hwnc',
        'fused_bottleneck_int8_plain',
        {'fused_bottleneck_int8_hwnc': INT8_CU}),
    'fused_bottleneck_down_int8_hwnc': _kernel(
        _PB + ':1234', _IK, 'fused_bottleneck_down_int8_hwnc',
        'fused_bottleneck_down_int8_plain',
        {'fused_bottleneck_down_int8_hwnc': INT8_CU}),
    'fused_bottleneck_down_s2_int8_hwnc': _kernel(
        _PB + ':1348', _IK, 'fused_bottleneck_down_s2_int8_hwnc',
        'fused_bottleneck_down_int8_plain',
        {'fused_bottleneck_down_s2_int8_hwnc': INT8_CU}),
}

NOT_IN_PORT = {
    'core/nn.py': {
        'kaiming_normal_fan_in': ('not copied', 'JAX PRNG-key helper; the '
                                  'port draws from explicit torch.Generators'),
        'split_keys': ('not copied', 'JAX PRNG-key helper; the port draws '
                       'from explicit torch.Generators'),
        'torch_linear_default': ('not copied', 'JAX PRNG-key helper; the '
                                 'port draws from explicit torch.Generators'),
    },
    'core/schedule.py': {
        'step_lr_jnp': ('replaced', 'instaorder_tpu_torch.core.schedule:'
                        'step_lr'),
    },
    'models/resnet.py': {
        'make': ('not copied', 'JAX PRNG-key init helper; the port draws '
                 'from explicit torch.Generators'),
    },
    'parallel/mesh.py': {
        'data_sharding': ('replaced', 'instaorder_tpu_torch.parallel.mesh:'
                          'shard_batch'),
        'replicated_sharding': ('not copied', 'each rank holds the whole '
                                'params; no sharding objects'),
    },
    'train/trainer.py': {
        'GlobalBatchSampler': ('not copied', 'each rank draws its own '
                               'sampler stream (held against JAX\'s '
                               'Trainer(n_devices=2))'),
    },
    'ops/pallas_blocks.py': {
        'bottleneck_reference': ('replaced', _B16 + ':fused_bottleneck_plain'),
        'bottleneck_down_reference': ('replaced',
                                      _B16 + ':fused_bottleneck_down_plain'),
        'stem_reference': ('replaced', _SK + ':fused_stem_plain'),
    },
}


def rows():
    """{chip_smoke row: (CUDA source, 'file:line' of the JAX it
    replaces)} over every kernel."""
    out = {}
    for k in KERNELS.values():
        out.update(k.rows)
    return out


def missing_rows(held):
    """The inventory's rows that are not in `held`, the rows a run held
    against their plain versions, in order."""
    return sorted(set(rows()) - set(held))


def coverage_line(held):
    """One line: how many of the inventory's rows and JAX functions a
    run held against their plain versions, and the rows it missed."""
    miss = missing_rows(held)
    fns = sum(1 for k in KERNELS.values() if set(k.rows) - set(miss))
    return (f'inventory coverage: {len(rows()) - len(miss)} of '
            f'{len(rows())} kernel rows held against their plain '
            f'versions ({fns} of {len(KERNELS)} JAX Pallas functions); '
            f'missing: {", ".join(miss) if miss else "none"}')
