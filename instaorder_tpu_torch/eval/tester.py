"""Tester — the offline evaluation harness (L6/L7; counterpart of
instaorder_tpu/eval/tester.py).

Parity with reference tools/test.py: per-image loop computing the
predicted order matrices through the batched OrderPredictor (one forward
over every pair of an image), occlusion R/P/F1 + depth WHDR accumulation
with the reference's -1-slice masking, bbox expansion with enlarge_box,
and the heuristic order methods.

The model is the unfolded `resnet.apply` at f32, as in the JAX package:
on the card that is the cuDNN f32 route with TF32 off
(`device.resolve_device`), and no hand-written kernel is reached. The
disparity route (`midas_pretrained`, or an InstaDepthNet with
`disp_select_method`) orders by a MiDaS disparity map
(`pipeline.DisparityOrderPredictor` over `disp.make_disp_forward`, cuDNN
f32 as well). Images are read with `data.image_io.read_rgb` (PNG without
PIL).

Where the JAX package's Tester fails, this one raises ValueError: an
InstaDepthNet through the model route (JAX's OrderPredictor feeds its
5-channel pair batch to the 3-channel trunk) and the disparity route
under SupDepthOccOrderDataset (JAX's DisparityOrderPredictor has no
infer_occ_depth_order).

Not ported yet (ROADMAP.md queue 1 item 4; each raises
NotImplementedError): the PartialCompletionMask (amodal) method and the
PNG dumps (`save_pngs`).
"""

from __future__ import annotations

import collections
import os
from typing import Dict

import numpy as np
import torch

from ..convert import to_numpy, to_torch
from ..core import checkpoint as ckpt
from ..data import readers as R
from ..data.image_io import read_rgb
from ..device import resolve_device
from ..models.folding import swap_conv1_w
from ..models.registry import get_backbone
from ..utils.telemetry import make_summary_logger
from . import heuristics as H
from .metrics import (eval_depth_order_whdr,
                      eval_order_recall_precision_f1)
from .pipeline import OrderPredictor

_QUEUE = 'not ported to instaorder_tpu_torch yet (ROADMAP.md queue 1 item 4)'


def expand_bbox(bboxes, enlarge_box=3.0):
    """Square-expand instance bboxes (tools/test.py:155-163)."""
    out = []
    for bbox in bboxes:
        cx = bbox[0] + bbox[2] / 2.0
        cy = bbox[1] + bbox[3] / 2.0
        size = max(np.sqrt(bbox[2] * bbox[3] * enlarge_box),
                   bbox[2] * 1.1, bbox[3] * 1.1)
        out.append([int(cx - size / 2.0), int(cy - size / 2.0),
                    int(size), int(size)])
    return np.array(out)


class Tester:
    # not a pytest test class despite the name (pytest would otherwise
    # warn it can't collect a class with an __init__)
    __test__ = False

    def __init__(self, args, logger=None, n_images=-1, device=None):
        """args: config namespace with .model/.data/.trainer + attributes
        order_method, pairs ('all'|'nbor'), zd, load_model,
        disp_select_method, save_pngs, out_dir. device: None is the card
        (device.resolve_device raises without one), 'cpu' the plain
        versions."""
        self.args = args
        self.device = resolve_device(device)
        self.order_method = getattr(args, 'order_method', None) or \
            args.model['algo']
        self.pairs = getattr(args, 'pairs', 'all')
        assert self.pairs in ('all', 'nbor')
        self.zd = getattr(args, 'zd', 0)
        self.save_pngs = getattr(args, 'save_pngs', 0)
        if self.save_pngs:
            raise NotImplementedError(f'Tester save_pngs: {_QUEUE}')
        self.out_dir = getattr(args, 'out_dir', 'out_pngs')
        self.logger = logger or _print_logger()
        self.curr_step = 0  # set from the loaded checkpoint
        # wandb/tensorboard val-metric hooks (tools/test.py:97-103,
        # 270-286). Events go next to the evaluated checkpoint (the
        # reference writes under the experiment save folder) unless an
        # explicit out_dir was given.
        events_dir = getattr(args, 'out_dir', None)
        if events_dir is None:
            load = getattr(args, 'load_model', None)
            # abspath so a bare/one-level filename ('ckpt.pth',
            # 'dir/ckpt.pth') still lands events next to the checkpoint
            # tree instead of silently under cwd
            events_dir = (os.path.dirname(os.path.dirname(
                os.path.abspath(load))) if load else self.out_dir)
        self.summary = make_summary_logger(
            args.trainer if hasattr(args, 'trainer') else {},
            events_dir, run_name='Test')

        data_cfg = args.data
        dataset = data_cfg['dataset']
        self.dataset = dataset
        if dataset == 'COCOA':
            self.data_reader = R.COCOAReader(data_cfg['val_annot_file'])
            self.gt_ordering = 'ann'
        elif dataset == 'InstaOrder':
            self.data_reader = R.InstaOrderReader(data_cfg['val_annot_file'])
            self.gt_ordering = 'ann'
        else:
            self.data_reader = R.KINSLVISReader(dataset,
                                                data_cfg['val_annot_file'])
            self.gt_ordering = 'man'
        self.data_root = data_cfg['val_image_root']
        self.data_length = self.data_reader.get_image_length()
        if n_images != -1:
            self.data_length = min(self.data_length, n_images)

        self.predictor = None

    # -- model -------------------------------------------------------------
    def prepare_model(self):
        args = self.args
        if self.order_method in H_METHODS:
            return  # heuristics need no model
        algo = args.model['algo']
        if (algo == 'midas_pretrained' or
                getattr(args, 'disp_select_method', '')):
            if args.data['trainval_dataset'] == 'SupDepthOccOrderDataset':
                raise ValueError(
                    f'{algo}: the disparity route orders depth only, and '
                    'SupDepthOccOrderDataset evaluates occlusion too (the '
                    "JAX package's DisparityOrderPredictor has no "
                    'infer_occ_depth_order either); evaluate a '
                    'SupDepthOrderDataset config')
            self.predictor = make_disparity_tester_predictor(args,
                                                             self.device)
            return
        if algo in DISP_ONLY_ALGOS:
            raise ValueError(
                f'{algo} is evaluated through the disparity route only: '
                'pass disp_select_method (median or mean) on a '
                "SupDepthOrderDataset config. The JAX package's model route "
                'fails for it too (its OrderPredictor feeds the 5-channel '
                'pair batch to the 3-channel MiDaS trunk)')
        if self.order_method == 'PartialCompletionMask':
            raise NotImplementedError(
                f'Tester PartialCompletionMask: {_QUEUE}')
        bb = get_backbone(args.model.get('backbone_arch', algo))
        params, stats, cfg = bb['init'](
            torch.Generator().manual_seed(0), device='cpu',
            **args.model.get('backbone_param', {}))
        load = getattr(args, 'load_model', None)
        if load:
            self.curr_step, params, stats, _ = ckpt.load_state(
                load, to_numpy(params), to_numpy(stats),
                warn=self.logger.info)
            params, stats = to_torch(params), to_torch(stats)
        # resnet_cls-family nets expose a top-level conv1: both swap
        # directions then run from the un-swapped pair batch, the second
        # through the conv1 with its mask rows exchanged (mask channels
        # 0, 1 enter only there) — no channel-swapped batch copy
        siamese_fn = None
        if 'conv1' in params and args.model.get('use_rgb', True):
            apply = bb['apply']

            def siamese_fn(p, s, c, x):
                p2 = dict(p, conv1=dict(
                    p['conv1'], w=swap_conv1_w(p['conv1']['w'])))
                return apply(p, s, c, x), apply(p2, s, c, x)

        self.predictor = OrderPredictor(
            bb['apply'], cfg, params, stats, self.order_method,
            patch_or_image=args.data['patch_or_image'],
            input_size=args.data['input_size'],
            use_rgb=args.model.get('use_rgb', True),
            siamese_fn=siamese_fn, device=self.device)

    # -- data helpers --------------------------------------------------------
    def _load_scene(self, i, with_gt=True):
        out = self.data_reader.get_image_instances(i, with_gt=with_gt)
        modal, category, bboxes, amodal, image_fn = out[:5]
        if self.args.data.get('use_category', False):
            modal = modal * category[:, None, None]
        image = read_rgb(os.path.join(self.data_root, image_fn))
        ebb = expand_bbox(bboxes, self.args.data.get('enlarge_box', 3.0))
        return modal, category, ebb, amodal, image_fn, image

    def _gt_occ(self, i, modal, amodal):
        if self.dataset == 'InstaOrder':
            return self.data_reader.get_gt_ordering(
                i, 'occlusion', self.args.data.get('remove_occ_bidirec', 0))
        if self.gt_ordering == 'man':
            return H.infer_gt_order(modal, amodal, device=self.device)
        return self.data_reader.get_gt_ordering(i)

    # -- dispatch -----------------------------------------------------------
    def run(self):
        self.prepare_model()
        tv = self.args.data['trainval_dataset']
        if tv == 'SupDepthOrderDataset':
            return self.eval_depth_order()
        if tv in ('SupOcclusionOrderDataset', 'PartialCompDataset'):
            return self.eval_occ_order()
        if tv == 'SupDepthOccOrderDataset':
            return self.eval_occ_depth_order()
        raise ValueError(tv)

    def _predict_occ(self, image, modal, bboxes, category=None):
        m = self.order_method
        if m == 'area':
            # reference eval_occ_order uses 'larger' for every dataset
            # (tools/test.py:420-426)
            return H.infer_occ_order_area(modal, occluder='larger',
                                          device=self.device)
        if m == 'yaxis':
            occluder = ('lower' if self.dataset in ('COCOA', 'InstaOrder')
                        else 'higher')
            return H.infer_occ_order_yaxis(modal, occluder=occluder,
                                           device=self.device)
        if m == 'hull':
            return H.infer_order_hull(modal)
        return self.predictor.infer_occ_order(
            image.astype(np.float32), modal.astype(np.float32),
            bboxes.astype(np.float32), pairs=self.pairs)

    def _predict_depth(self, image, modal, bboxes):
        m = self.order_method
        if m == 'area':
            return H.infer_depth_order_area(modal, closer='larger')
        if m == 'yaxis':
            closer = ('lower' if self.dataset in ('COCOA', 'InstaOrder')
                      else 'higher')
            return H.infer_depth_order_yaxis(modal, closer=closer)
        return self.predictor.infer_depth_order(
            image.astype(np.float32), modal.astype(np.float32),
            bboxes.astype(np.float32), pairs=self.pairs)

    # -- eval loops -----------------------------------------------------------
    def eval_occ_order(self):
        rs, ps, f1s = [], [], []
        for i in range(self.data_length):
            modal, cat, bboxes, amodal, fn, image = self._load_scene(i)
            gt = self._gt_occ(i, modal, amodal)
            pred = self._predict_occ(image, modal, bboxes, cat)
            r, p, f1 = eval_order_recall_precision_f1(pred, gt, self.zd)
            rs.append(r)
            ps.append(p)
            f1s.append(f1)
            self.logger.info(
                f'[{fn}]\trecall={r:.3f} / precision={p:.3f} / f1={f1:.3f}')
        out = {'recall': float(np.mean(rs)),
               'precision': float(np.mean(ps)),
               'f1': float(np.mean(f1s)), 'n': len(rs)}
        self.logger.info(
            f"[AVERAGE] recall={out['recall']:.3f} / "
            f"precision={out['precision']:.3f} / f1={out['f1']:.3f}")
        # tools/test.py:276-286 logs the summary metrics at the
        # evaluated checkpoint's step
        self.summary.scalars({'val/recall': out['recall'],
                              'val/precision': out['precision'],
                              'val/f1': out['f1'],
                              'val/num_test_images': out['n']},
                             self.curr_step)
        return out

    def eval_depth_order(self):
        whdr_acc: Dict[str, list] = collections.defaultdict(list)
        for i in range(self.data_length):
            modal, cat, bboxes, amodal, fn, image = self._load_scene(i)
            gt_d = self.data_reader.get_gt_ordering(
                i, 'depth',
                rm_overlap=self.args.data.get('remove_depth_overlap', 0))
            pred = self._predict_depth(image, modal, bboxes)
            per = eval_depth_order_whdr(pred, gt_d)
            for k, v in per.items():
                whdr_acc[k].append(v[0])
            self.logger.info(
                f"[{fn}]\t{per['ovlX_all'][0]:.3f} | "
                f"{per['ovlO_all'][0]:.3f} | {per['ovlOX_all'][0]:.3f}")
        return self._finish_whdr(whdr_acc)

    def eval_occ_depth_order(self):
        rs, ps, f1s = [], [], []
        whdr_acc: Dict[str, list] = collections.defaultdict(list)
        for i in range(self.data_length):
            modal, cat, bboxes, amodal, fn, image = self._load_scene(i)
            gt_d = self.data_reader.get_gt_ordering(i, 'depth')
            gt_o = self.data_reader.get_gt_ordering(
                i, 'occlusion', self.args.data.get('remove_occ_bidirec', 0))
            occ, dep = self.predictor.infer_occ_depth_order(
                image.astype(np.float32), modal.astype(np.float32),
                bboxes.astype(np.float32), pairs=self.pairs)
            per = eval_depth_order_whdr(dep, gt_d)
            for k, v in per.items():
                whdr_acc[k].append(v[0])
            r, p, f1 = eval_order_recall_precision_f1(occ, gt_o, self.zd)
            rs.append(r)
            ps.append(p)
            f1s.append(f1)
            self.logger.info(
                f"[{fn}]\t{per['ovlX_all'][0]:.3f} | {per['ovlO_all'][0]:.3f}"
                f" | {per['ovlOX_all'][0]:.3f}\n\t\t\trecall={r:.3f} / "
                f"precision={p:.3f} / f1={f1:.3f}")
        out = self._finish_whdr(whdr_acc)
        out.update({'recall': float(np.mean(rs)),
                    'precision': float(np.mean(ps)),
                    'f1': float(np.mean(f1s))})
        self.logger.info(
            f"[AVERAGE] recall={out['recall']:.3f} / "
            f"precision={out['precision']:.3f} / f1={out['f1']:.3f}")
        self.summary.scalars({'val/recall': out['recall'],
                              'val/precision': out['precision'],
                              'val/f1': out['f1']}, self.curr_step)
        return out

    def _finish_whdr(self, whdr_acc):
        """Mean over images skipping the -1 empty-slice sentinel
        (tools/test.py:265-272)."""
        out = {}
        self.logger.info('[MEAN WHDR]')
        for key, vals in whdr_acc.items():
            arr = np.array(vals, dtype=np.float64)
            valid = arr != -1
            mean = arr[valid].sum() / (valid.sum() + 1e-6)
            out[f'WHDR_{key}'] = float(mean)
            self.logger.info(f'{key}: {mean}')
            # tools/test.py:270: val_<ovl>/WHDR_<eq> per-key means
            ko, ke = key.split('_', 1)
            self.summary.scalar(f'val_{ko}/WHDR_{ke}', mean,
                                self.curr_step)
        return out


H_METHODS = ('area', 'yaxis', 'hull')
# the nets whose order heads the Tester cannot score (see the module doc)
DISP_ONLY_ALGOS = ('InstaDepthNet_d', 'InstaDepthNet_od')


def _print_logger():
    import logging
    logger = logging.getLogger('instaorder_tpu_torch.tester')
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter('[%(asctime)s] %(message)s'))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def make_disparity_tester_predictor(args, device=None):
    """The DisparityOrderPredictor of midas_pretrained / InstaDepthNet-with-
    disp_select_method evaluation, on `device` (None: the card)."""
    from .disp import make_disp_forward
    from .pipeline import DisparityOrderPredictor
    dev = resolve_device(device)
    return DisparityOrderPredictor(
        make_disp_forward(args.model['algo'],
                          getattr(args, 'load_model', None),
                          features=args.model.get('features', 256),
                          device=dev),
        select_method=getattr(args, 'disp_select_method', 'median')
        or 'median',
        input_size=args.data['input_size'], device=dev)
