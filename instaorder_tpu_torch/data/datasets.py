"""Training datasets: host-side sampling into fixed-shape numpy samples
(counterpart of instaorder_tpu/data/datasets.py).

  SupOcclusionOrderDataset  <- datasets/occ_order_dataset.py
  SupDepthOrderDataset      <- datasets/depth_order_dataset.py
  SupDepthOccOrderDataset   <- datasets/depth_occ_order_dataset.py

Each `sample(idx, rng)` returns a dict in train/algos.py's batch
convention (NHWC rgb, (H, W) float masks, label fields). Randomness
flows through the numpy RandomState passed in, drawn in the JAX
package's order, so that the same (idx, rng) gives the same pair, crop,
flip and swap in both packages.

No cv2 and no PIL: images come through `image_io.read_rgb`; the mask
resizes use cv2's INTER_NEAREST rule (`ops.resize.resize_nearest_np`),
the RGB ones cv2's INTER_CUBIC (patch mode: `ops.resize.resize_cubic_u8`,
the f32 cubic resize rounded and saturated to uint8) and INTER_LINEAR
(image and resize modes: `ops.resize.resize_linear_u8`, cv2's
fixed-point arithmetic).

`PartialCompDataset` (PCNet-M's self-supervised erasing) belongs to the
UNet network, which is not ported yet: it raises NotImplementedError
(ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import os

import numpy as np

from . import readers as R
from .image_io import read_rgb
from ..ops.resize import (resize_cubic_u8, resize_linear_u8,
                          resize_nearest_np)
from ..utils.geometry import crop_padding, pair_crop_bbox

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _normalize(rgb_uint8):
    x = rgb_uint8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def _make_reader(config, phase):
    dataset = config['dataset']
    annot = config[f'{phase}_annot_file']
    if dataset == 'COCOA':
        return R.COCOAReader(annot)
    if dataset == 'InstaOrder':
        return R.InstaOrderReader(annot)
    if dataset == 'Mapillary':
        raise NotImplementedError(
            'the Mapillary reader is not ported to instaorder_tpu_torch')
    return R.KINSLVISReader(dataset, annot)


class _PairDatasetBase:
    """The three crop modes (patch / image / resize) and image loading."""

    def __init__(self, config, phase):
        self.config = config
        self.phase = phase
        self.sz = config['input_size']
        self.data_reader = _make_reader(config, phase)
        self.mode = config['patch_or_image']
        if self.mode not in ('patch', 'image', 'resize'):
            raise ValueError(f'patch_or_image: {self.mode}')

    def _load_image(self, fn):
        root = self.config[f'{self.phase}_image_root']
        return read_rgb(os.path.join(root, fn))

    def _flip(self, rng, *arrays):
        if self.config['base_aug']['flip'] and rng.rand() > 0.5:
            return tuple(a[:, ::-1].copy() for a in arrays)
        return arrays

    def _finish(self, rng, m1, m2, rgb):
        """Flip (one draw) and normalise, as every mode ends."""
        if rgb is None:
            m1, m2 = self._flip(rng, m1, m2)
            return m1, m2, None
        m1, m2, rgb = self._flip(rng, m1, m2, rgb)
        return m1, m2, _normalize(rgb)

    def _get_pair(self, modal, bboxes, idx1, idx2, imgfn, rng,
                  load_rgb=True, randshift=False):
        """patch mode: union-bbox square crop + train shift/scale aug
        (occ_order_dataset.py:138-180)."""
        shift = self.config['base_aug']['shift'] if (
            self.phase == 'train' and randshift) else None
        scale = self.config['base_aug']['scale'] if (
            self.phase == 'train') else None
        roi = pair_crop_bbox(bboxes[idx1], bboxes[idx2], shift, scale, rng)
        sz = self.sz
        m1 = resize_nearest_np(crop_padding(modal[idx1], roi, (0,)), sz, sz)
        m2 = resize_nearest_np(crop_padding(modal[idx2], roi, (0,)), sz, sz)
        rgb = None
        if load_rgb:
            img = self._load_image(imgfn)
            rgb = resize_cubic_u8(crop_padding(img, roi, (0, 0, 0)), sz, sz)
        return self._finish(rng, m1, m2, rgb)

    def _get_pair_image(self, modal, bboxes, idx1, idx2, imgfn, rng,
                        load_rgb=True, randshift=False):
        """image mode: pad-to-square + resize (occ_order_dataset.py:
        99-136)."""
        _, hh, ww = modal.shape
        side = int(max(hh, ww))
        left, top = (side - ww) // 2, (side - hh) // 2

        def pad(m):
            out = np.zeros((side, side) + m.shape[2:], m.dtype)
            out[top:top + hh, left:left + ww] = m
            return out

        sz = self.sz
        m1 = resize_nearest_np(pad(modal[idx1]), sz, sz)
        m2 = resize_nearest_np(pad(modal[idx2]), sz, sz)
        rgb = None
        if load_rgb:
            rgb = resize_linear_u8(pad(self._load_image(imgfn)), sz, sz)
        return self._finish(rng, m1, m2, rgb)

    def _get_pair_resize(self, modal, bboxes, idx1, idx2, imgfn, rng,
                         load_rgb=True, randshift=False):
        """resize mode: full-image resize (occ_order_dataset.py:81-97)."""
        sz = self.sz
        m1 = resize_nearest_np(modal[idx1], sz, sz)
        m2 = resize_nearest_np(modal[idx2], sz, sz)
        rgb = None
        if load_rgb:
            rgb = resize_linear_u8(self._load_image(imgfn), sz, sz)
        return self._finish(rng, m1, m2, rgb)

    def _pair_fn(self):
        return {'patch': self._get_pair, 'image': self._get_pair_image,
                'resize': self._get_pair_resize}[self.mode]

    def _zero_rgb(self):
        return np.zeros((self.sz, self.sz, 3), np.float32)


def _swapped(rgb, m1, m2, **labels):
    return {'rgb': rgb, 'modal1': m1.astype(np.float32),
            'modal2': m2.astype(np.float32), **labels}


class SupOcclusionOrderDataset(_PairDatasetBase):
    """Per-image occluded / non-occluded pair sampling; emits OrderNet
    1-of-{3,4} labels or InstaOrderNet_o 2-bit vectors."""

    def __init__(self, config, phase, algo):
        super().__init__(config, phase)
        self.algo = algo
        self.rm_bidirec = config['remove_occ_bidirec']
        self.dataset = config['dataset']

    def __len__(self):
        return self.data_reader.get_image_length()

    def _gt_matrix(self, idx):
        # NB use_category multiplies BEFORE the KINS gt derivation, as the
        # reference does (occ_order_dataset.py:183-188), a quirk kept for
        # parity (the shipped configs all use use_category: False)
        modal, category, bboxes, amodal, fn = \
            self.data_reader.get_image_instances(idx, with_gt=True)
        if self.dataset == 'KINS':
            from ..eval.heuristics import infer_gt_order
            if self.config.get('use_category', False):
                modal = modal * category[:, None, None]
            return modal, bboxes, fn, infer_gt_order(modal, amodal)
        if self.dataset == 'InstaOrder':
            gt = self.data_reader.get_gt_ordering(
                idx, type='occlusion', rm_bidirec=self.rm_bidirec)
        else:
            gt = self.data_reader.get_gt_ordering(idx)
        if self.config.get('use_category', False):
            modal = modal * category[:, None, None]
        return modal, bboxes, fn, gt

    def _pair_ind(self, idx, rng):
        modal, bboxes, fn, gt = self._gt_matrix(idx)
        np.fill_diagonal(gt, -1)
        pairs = np.where(gt == 1)
        non_pairs = np.where(gt == 0)
        if len(pairs[0]) == 0:
            return self._pair_ind(rng.choice(len(self)), rng)
        return modal, bboxes, fn, pairs, non_pairs, gt

    def _draw_pair(self, rng, pairs, non_pairs):
        """70% an occluded pair (always, if no other), else a
        non-occluded one; returns (idx1, idx2, occluded)."""
        if rng.rand() < 0.7 or len(non_pairs[0]) == 0:
            k = rng.choice(len(pairs[0]))
            return pairs[0][k], pairs[1][k], True
        k = rng.choice(len(non_pairs[0]))
        return non_pairs[0][k], non_pairs[1][k], False

    def sample(self, idx, rng):
        modal, bboxes, fn, pairs, non_pairs, gt = self._pair_ind(idx, rng)
        idx1, idx2, occluded = self._draw_pair(rng, pairs, non_pairs)
        m1, m2, rgb = self._pair_fn()(modal, bboxes, idx1, idx2, fn, rng,
                                      load_rgb=self.config['load_rgb'],
                                      randshift=True)
        rgb = rgb if rgb is not None else self._zero_rgb()
        if self.algo == 'OrderNet':
            # labels: 0 B-over-A / 1 A-over-B / 2 none / 3 bidirec
            label = 2
            if occluded:
                label = 1
                if self.config['extend_bidirec'] and gt[idx2, idx1]:
                    label = 3
            if rng.rand() < 0.5:
                return _swapped(rgb, m1, m2, label=label)
            return _swapped(rgb, m2, m1, label=0 if label == 1 else label)
        if self.algo != 'InstaOrderNet_o':
            raise ValueError(f'SupOcclusionOrderDataset: algo {self.algo}')
        a_over_b = gt[idx1, idx2]
        b_over_a = gt[idx2, idx1]
        if rng.rand() < 0.5:
            return _swapped(rgb, m1, m2, occ_order=np.array(
                [b_over_a, a_over_b], np.float32))
        return _swapped(rgb, m2, m1, occ_order=np.array(
            [a_over_b, b_over_a], np.float32))


class _DepthPairBase(_PairDatasetBase):
    def __init__(self, config, phase):
        super().__init__(config, phase)
        self.rm_overlap = config.get('remove_depth_overlap', 0)
        self.length = self.data_reader.get_geometric_length()

    def __len__(self):
        return self.length

    def _depth_label(self, gt_depth, idx1, idx2):
        if gt_depth[idx1, idx2] == -1:
            return -1
        if gt_depth[idx1, idx2] == 1 and gt_depth[idx2, idx1] == 0:
            return 0
        if gt_depth[idx1, idx2] == 2:
            return 2
        raise ValueError('inconsistent depth matrix entry')

    def _pair(self, idx, use_category):
        """The depth pair `idx`: (img_id, idx1, idx2, modal, bboxes, fn,
        (gt_depth, gt_overlap, gt_count)), or None when the image has
        no depth label at all."""
        img_id, g_order = self.data_reader.get_imgId_and_depth(idx)
        modal, category, bboxes, _, fn = \
            self.data_reader.get_image_instances(img_id, with_gt=True)
        if use_category:
            modal = modal * category[:, None, None]
        gts = self.data_reader.get_gt_ordering(
            img_id, type='depth', rm_overlap=self.rm_overlap)
        sep = '<' if '<' in g_order else '='
        idx1, idx2 = map(int, g_order.split(sep))
        return img_id, idx1, idx2, modal, bboxes, fn, gts

    def _crop(self, rng, modal, bboxes, idx1, idx2, fn):
        m1, m2, rgb = self._pair_fn()(modal, bboxes, idx1, idx2, fn, rng,
                                      load_rgb=self.config['load_rgb'],
                                      randshift=True)
        return m1, m2, rgb if rgb is not None else self._zero_rgb()


class SupDepthOrderDataset(_DepthPairBase):
    """Iterates the depth *pair* list (not images),
    depth_order_dataset.py."""

    def __init__(self, config, phase, algo):
        super().__init__(config, phase)
        self.algo = algo

    def sample(self, idx, rng):
        _, idx1, idx2, modal, bboxes, fn, gts = self._pair(
            idx, self.config.get('use_category', False))
        gt_depth, gt_overlap, gt_count = gts
        if gt_depth.sum() == -gt_depth.size:
            return self.sample(rng.choice(len(self)), rng)
        m1, m2, rgb = self._crop(rng, modal, bboxes, idx1, idx2, fn)
        label = self._depth_label(gt_depth, idx1, idx2)
        extra = {'count': gt_count[idx1, idx2],
                 'is_overlap': gt_overlap[idx1, idx2]}
        if rng.rand() < 0.5:
            return _swapped(rgb, m1, m2, depth_order=label, **extra)
        return _swapped(rgb, m2, m1, depth_order=1 if label == 0 else label,
                        **extra)


class SupDepthOccOrderDataset(_DepthPairBase):
    """Joint depth + occlusion labels for the same pair,
    depth_occ_order_dataset.py."""

    def __init__(self, config, phase, algo):
        super().__init__(config, phase)
        self.algo = algo
        self.rm_bidirec = config['remove_occ_bidirec']

    def sample(self, idx, rng):
        img_id, idx1, idx2, modal, bboxes, fn, gts = self._pair(idx, False)
        gt_depth, gt_overlap, gt_count = gts
        gt_occ = self.data_reader.get_gt_ordering(
            img_id, type='occlusion', rm_bidirec=self.rm_bidirec)
        m1, m2, rgb = self._crop(rng, modal, bboxes, idx1, idx2, fn)
        label = self._depth_label(gt_depth, idx1, idx2)
        extra = {'count': gt_count[idx1, idx2],
                 'is_overlap': gt_overlap[idx1, idx2]}
        a_over_b = gt_occ[idx1, idx2]
        b_over_a = gt_occ[idx2, idx1]
        if rng.rand() < 0.5:
            return _swapped(rgb, m1, m2, depth_order=label, **extra,
                            occ_order=np.array([b_over_a, a_over_b],
                                               np.float32))
        return _swapped(rgb, m2, m1, depth_order=1 if label == 0 else label,
                        **extra, occ_order=np.array([a_over_b, b_over_a],
                                                    np.float32))


class PartialCompDataset:
    """PCNet-M self-supervised erasing (partial_comp_dataset.py): not
    ported yet."""

    def __init__(self, config, phase, algo=None):
        raise NotImplementedError(
            'PartialCompDataset is not ported to instaorder_tpu_torch yet '
            '(ROADMAP.md queue 1 item 4: the UNet network)')


DATASETS = {
    'SupOcclusionOrderDataset': SupOcclusionOrderDataset,
    'SupDepthOrderDataset': SupDepthOrderDataset,
    'SupDepthOccOrderDataset': SupDepthOccOrderDataset,
    'PartialCompDataset': PartialCompDataset,
}


def collate(samples):
    """Stack a list of sample dicts into a batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}
