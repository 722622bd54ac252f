"""The port's torch-checkpoint converters (instaorder_tpu_torch/compat)
against the JAX package's (instaorder_tpu/compat) on the CPU.

State dicts come from tests/torch_ref.py's modules at small size (a
ResNet with one block a stage: 5-channel single and dual heads, an
ImageNet-style 3-channel 1000-way one; a UNet; MidasNet and
InstaDepthNet_od / _d in the reference's naming) and, for the UNetResNet
variant, from a tree written back in the reference's names. Both
packages convert each one; the trees must hold the same keys, shapes and
values (every value equal). `load_pretrain`'s lenient merge must log the
same warnings as JAX's and give the same trees; the convert CLI's file
must load through the port's `load_state` to the converted tree.
"""

import numpy as np
import pytest
import torch

from instaorder_tpu.compat import convert_cli as JCLI
from instaorder_tpu.compat import torch_convert as JC
from instaorder_tpu.compat import torch_convert_midas as JCM
from instaorder_tpu.compat import torch_convert_unet as JCU

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.compat import convert_cli as TCLI
from instaorder_tpu_torch.compat import torch_convert as TC
from instaorder_tpu_torch.compat import torch_convert_midas as TCM
from instaorder_tpu_torch.compat import torch_convert_unet as TCU
from instaorder_tpu_torch.core import checkpoint as ckpt
from instaorder_tpu_torch.core.nn import tree_leaves
from instaorder_tpu_torch.models import midas as tmidas
from instaorder_tpu_torch.models import resnet as tresnet
from instaorder_tpu_torch.models import unet as tunet

from torch_ref import TorchMidasOracle, TorchResNetCls, TorchUNet
import torch_threads  # noqa: F401 (the suite's torch thread cap)

SMALL = (1, 1, 1, 1)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def randomised(module, seed):
    """A module's state dict with every BatchNorm's running statistics
    and affine parameters drawn from a seed (the defaults, 0 / 1, would
    leave most of a comparison trivial)."""
    g = torch.Generator().manual_seed(seed)
    sd = module.state_dict()
    for k, v in sd.items():
        if v.is_floating_point() and k.endswith(('running_mean', 'bias')):
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
        elif v.is_floating_point() and k.endswith('running_var'):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif v.is_floating_point() and v.ndim == 1:
            sd[k] = 1 + 0.1 * torch.randn(v.shape, generator=g)
    return sd


def assert_same_tree(got, want, path='tree'):
    """Same keys (dicts), lengths (lists), shapes, dtypes and values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f'{path}.{k}')
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), path
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f'{path}[{i}]')
    else:
        assert isinstance(got, torch.Tensor), path
        w = np.asarray(want)
        g = got.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def resnet_cfg(in_channels, classes, arch='resnet50', with_head=True):
    return tresnet.init(gen(), arch=arch, in_channels=in_channels,
                        num_classes=classes, layers_override=SMALL,
                        with_head=with_head)[2]


# (case, torch module kwargs, prefix)
RESNET_CASES = [
    ('single', dict(in_channels=5, num_classes=2), ''),
    ('dual', dict(in_channels=5, num_classes=[2, 3]), 'module.'),
    ('imagenet', dict(in_channels=3, num_classes=1000), ''),
]


@pytest.mark.parametrize('case,kw,prefix', RESNET_CASES,
                         ids=[c[0] for c in RESNET_CASES])
def test_resnet_matches_jax(case, kw, prefix):
    tm = TorchResNetCls(layers=SMALL, **kw)
    sd = {prefix + k: v for k, v in randomised(tm, 1).items()}
    cfg = resnet_cfg(kw['in_channels'], kw['num_classes'])
    got = TC.resnet_from_torch_state_dict(sd, cfg)
    want = JC.resnet_from_torch_state_dict(sd, cfg)
    for g, w in zip(got, want):
        assert_same_tree(g, w)
    # the tree runs: the port's eval forward equals the torch module's
    x = np.random.RandomState(2).randn(2, 64, 64, kw['in_channels']).astype(
        np.float32)
    tm.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    with torch.no_grad():
        ref = tm.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        out = tresnet.apply(*got, cfg, torch.from_numpy(x))
    for o, r in zip(out if kw['num_classes'] == [2, 3] else [out],
                    ref if kw['num_classes'] == [2, 3] else [ref]):
        assert (o - r).abs().max() <= 1e-5 * r.abs().max()


def test_resnet_lenient_matches_jax():
    """A partial state dict (no running statistics on one BatchNorm, no
    head, a block's conv missing): lenient trees equal JAX's; strict ones
    raise the same KeyError."""
    sd = randomised(TorchResNetCls(layers=SMALL, in_channels=5,
                                   num_classes=2), 3)
    for k in ('layer2.0.bn1.running_mean', 'layer2.0.bn1.running_var',
              'fc.weight', 'fc.bias', 'layer3.0.conv2.weight'):
        del sd[k]
    cfg = resnet_cfg(5, 2)
    for g, w in zip(TC.resnet_from_torch_state_dict(sd, cfg, lenient=True),
                    JC.resnet_from_torch_state_dict(sd, cfg, lenient=True)):
        assert_same_tree(g, w)
    with pytest.raises(KeyError) as te:
        TC.resnet_from_torch_state_dict(sd, cfg)
    with pytest.raises(KeyError) as je:
        JC.resnet_from_torch_state_dict(sd, cfg)
    assert te.value.args == je.value.args


def od_state_dict(variant, seed):
    """A reference-named InstaDepthNet_od (or _d: the do branch renamed
    gdo_net, its depth_fc renamed fc, the oo branch dropped) or MidasNet
    state dict at trunk (1, 1, 1, 1), features 8."""
    tm = TorchMidasOracle(trunk_layers=SMALL, branch_layers=SMALL,
                          features=8,
                          variant='midas' if variant == 'midas' else 'od')
    sd = randomised(tm, seed)
    if variant != 'instadepthnet_d':
        return sd
    out = {}
    for k, v in sd.items():
        if k.startswith('oo_net.') or k.startswith('occ_fc.'):
            continue
        k = k.replace('do_net.', 'gdo_net.', 1) if k.startswith(
            'do_net.') else k
        out['fc.' + k[len('depth_fc.'):] if k.startswith('depth_fc.')
            else k] = v
    return out


@pytest.mark.parametrize('variant', ['midas', 'instadepthnet_d',
                                     'instadepthnet_od'])
def test_midas_matches_jax(variant):
    sd = od_state_dict(variant, 4)
    cfg = tmidas.init(gen(), features=8, variant=variant,
                      trunk_layers=SMALL, branch_layers=SMALL)[2]
    for g, w in zip(TCM.midas_from_torch_state_dict(sd, cfg),
                    JCM.midas_from_torch_state_dict(sd, cfg)):
        assert_same_tree(g, w)
    for g, w in zip(TCM.midas_base_from_torch_state_dict(sd, cfg),
                    JCM.midas_base_from_torch_state_dict(sd, cfg)):
        assert_same_tree(g, w)
    p, s = TCM.midas_from_torch_state_dict(sd, cfg)
    want = tmidas.init(gen(), features=8, variant=variant,
                       trunk_layers=SMALL, branch_layers=SMALL)
    for g, w in zip((p, s), want[:2]):
        assert [tuple(x.shape) for x in tree_leaves(g)] == \
            [tuple(x.shape) for x in tree_leaves(w)]


def unet_state_dict(params, stats, cfg):
    """The reference's UNet / UNetResNet state dict of a port tree (the
    inverse of compat's map; up<i> as UNet names them)."""
    sd = {}

    def conv(name, p):
        sd[f'{name}.weight'] = p['w'].permute(3, 2, 0, 1).contiguous()
        if 'b' in p:
            sd[f'{name}.bias'] = p['b']

    def bn(name, p, s):
        sd.update({f'{name}.weight': p['scale'], f'{name}.bias': p['bias'],
                   f'{name}.running_mean': s['mean'],
                   f'{name}.running_var': s['var']})

    def double(pre, p, s):
        conv(f'{pre}.0', p['conv1'])
        bn(f'{pre}.1', p['bn1'], s['bn1'])
        conv(f'{pre}.3', p['conv2'])
        bn(f'{pre}.4', p['bn2'], s['bn2'])

    double('inc.conv.conv', params['inc'], stats['inc'])
    for i in range(1, cfg['depth'] + 1):
        double(f'down{i}.mpconv.1.conv', params[f'down{i}'],
               stats[f'down{i}'])
    for i in range(1, cfg['n_ups'] + 1):
        double(f'up{i}.conv.conv', params[f'up{i}'], stats[f'up{i}'])
    conv('outc.conv', params['outc'])
    if cfg['use_rgb_encoder']:
        enc_p, enc_s = params['image_encoder'], stats['image_encoder']
        conv('image_encoder.conv1', enc_p['conv1'])
        bn('image_encoder.bn1', enc_p['bn1'], enc_s['bn1'])
        for li in range(1, 5):
            for bi, (bp, bs) in enumerate(zip(enc_p[f'layer{li}'],
                                              enc_s[f'layer{li}'])):
                pre = f'image_encoder.layer{li}.{bi}'
                for ci in (1, 2):
                    conv(f'{pre}.conv{ci}', bp[f'conv{ci}'])
                    bn(f'{pre}.bn{ci}', bp[f'bn{ci}'], bs[f'bn{ci}'])
                if 'down_conv' in bp:
                    conv(f'{pre}.downsample.0', bp['down_conv'])
                    bn(f'{pre}.downsample.1', bp['down_bn'], bs['down_bn'])
        conv('reduce_dim.0', params['reduce_conv'])
        bn('reduce_dim.1', params['reduce_bn'], stats['reduce_bn'])
    return sd


@pytest.mark.parametrize('case', ['torch_ref', 'unet025res'])
def test_unet_matches_jax(case):
    if case == 'torch_ref':
        sd = randomised(TorchUNet(in_channels=2, w=0.5, n_classes=2), 5)
        cfg = tunet.init(gen(), in_channels=2, w=0.5, n_classes=2)[2]
    else:
        p, s, cfg = tunet.init(gen(6), in_channels=2, n_classes=2,
                               **tunet.UNET_FACTORIES[case])
        sd = unet_state_dict(p, s, cfg)
    got = TCU.unet_from_torch_state_dict(sd, cfg)
    for g, w in zip(got, JCU.unet_from_torch_state_dict(sd, cfg)):
        assert_same_tree(g, w)
    if case != 'torch_ref':
        for g, w in zip(got, (p, s)):       # the tree written back
            assert_same_tree(g, convert.to_numpy(w))


@pytest.mark.parametrize('family', ['resnet', 'midas_base'])
def test_load_pretrain_matches_jax(family, tmp_path):
    """The training-time ingest: ImageNet-style weights onto a 5-channel
    dual-head net (conv1 and the heads keep the init, with JAX's
    warnings), and a MidasNet file onto InstaDepthNet_od (the order
    branches keep theirs)."""
    if family == 'resnet':
        sd = randomised(TorchResNetCls(layers=SMALL, in_channels=3,
                                       num_classes=1000), 7)
        params, stats, cfg = tresnet.init(
            gen(8), arch='resnet50', in_channels=5, num_classes=[2, 3],
            weight_init='xavier', layers_override=SMALL)
    else:
        sd = od_state_dict('midas', 9)
        params, stats, cfg = tmidas.init(
            gen(8), features=8, variant='instadepthnet_od',
            trunk_layers=SMALL, branch_layers=SMALL)
    path = str(tmp_path / 'weights.pth')
    torch.save(sd, path)
    tw, jw = [], []
    tp, ts = TC.load_pretrain(path, params, stats, cfg, family=family,
                              warn=tw.append)
    jp, js = JC.load_pretrain(path, convert.to_numpy(params),
                              convert.to_numpy(stats), cfg, family=family,
                              warn=jw.append)
    assert tw == jw and len(tw) >= 2
    assert_same_tree(tp, jax_numpy(jp))
    assert_same_tree(ts, jax_numpy(js))
    keep = ('conv1', 'fc_occ', 'fc_depth') if family == 'resnet' else \
        ('do', 'oo')
    for k in keep:
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(tp[k]), tree_leaves(params[k])))


def jax_numpy(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def test_convert_checkpoint_and_cli(tmp_path):
    """A reference .pth.tar ({step, state_dict} with the `module.`
    prefix) of the full ResNet-50 InstaOrderNet_od: convert_checkpoint
    equal to JAX's; the CLI's file loads through the port's load_state
    to the same tree; ALGO_SPECS as JAX's."""
    assert TCLI.ALGO_SPECS == JCLI.ALGO_SPECS
    tm = TorchResNetCls(in_channels=5, num_classes=[2, 3])
    sd = {f'module.{k}': v for k, v in randomised(tm, 10).items()}
    pth = str(tmp_path / 'InstaOrder_InstaOrderNet_od.pth.tar')
    torch.save({'step': 123, 'state_dict': sd}, pth)
    cfg = tresnet.init(gen(), arch='resnet50', in_channels=5,
                       num_classes=[2, 3])[2]
    tp, ts, tstep = TC.convert_checkpoint(pth, cfg)
    jp, js, jstep = JC.convert_checkpoint(pth, cfg)
    assert tstep == jstep == 123
    assert_same_tree(tp, jax_numpy(jp))
    assert_same_tree(ts, jax_numpy(js))
    out = str(tmp_path / 'ckpt_iter_0.ckpt')
    assert TCLI.main(['--torch-ckpt', pth, '--algo', 'InstaOrderNet_od',
                      '--out', out]) == out
    step, lp, ls, _ = ckpt.load_state(out, convert.to_numpy(tp),
                                      convert.to_numpy(ts))
    assert step == 123
    assert_same_tree(convert.to_torch(lp), jax_numpy(jp))
    assert_same_tree(convert.to_torch(ls), jax_numpy(js))
