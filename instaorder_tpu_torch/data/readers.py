"""Annotation readers (host-side ingest; counterpart of
instaorder_tpu/data/readers.py).

Capability parity with the reference's `datasets/reader.py`:
  read_KINS / read_LVIS / read_COCOA  <- reader.py:20-66
  InstaOrderReader                    <- reader.py:294-457
  COCOAReader                         <- reader.py:209-291
  KINSLVISReader                      <- reader.py:460-539
  MapillaryReader                     <- reader.py:542-599

  KITTIReader / NYUReader / DIWReader <- reader.py:69-206 (the dense
                                         disparity eval, eval/disp.py)

MapillaryReader (a training reader: instance maps, no ground-truth
order) reads `{root}/instances/{image_id}.png` with `image_io.read_gray`
(16-bit PNG without PIL). The disparity readers read images with
`image_io.read_rgb` (PNG without PIL; other formats through PIL at call
time) and resize to 384^2 with `ops/resize.resize_linear_u8`, equal to
cv2.INTER_LINEAR on every value.

Masks decode through the port's data/rle.py (pycocotools-compatible);
order strings ("i<j", "i<j & j<i", "i=j", "1-2,...") parse into the
reference's matrix conventions:
  occlusion: 1 = row-occludes-col (bidirectional -> both), -1 optionally
             for removed bidirectional pairs
  depth:     -1 unannotated; 1/0 closer/farther; 2 equal; plus overlap
             and annotator-count matrices.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from . import rle
from .image_io import read_gray, read_rgb
from ..ops.resize import resize_linear_u8
from ..utils.geometry import mask_to_bbox


# ---------------------------------------------------------------------------
# per-annotation decoders
# ---------------------------------------------------------------------------

def read_KINS(ann):
    modal = rle.decode(ann['inmodal_seg'])
    bbox = ann['inmodal_bbox']
    category = ann['category_id']
    score = ann.get('score', 1.0)
    return modal, bbox, category, score


def read_LVIS(ann, h, w):
    segm = ann['segmentation']
    if isinstance(segm, list):
        r = rle.merge(rle.fr_poly_objects(segm, h, w))
    elif isinstance(segm.get('counts'), list):
        r = rle.fr_poly_objects(segm, h, w)
    else:
        r = segm
    return rle.decode(r), ann['bbox'], ann['category_id']


def read_COCOA(ann, h, w):
    if 'visible_mask' in ann:
        modal = rle.decode(ann['visible_mask'])
    else:
        modal = rle.decode(rle.merge(
            rle.fr_poly_objects([ann['segmentation']], h, w)))
    modal = np.squeeze(modal)
    if np.all(modal != 1):
        # fully occluded: approximate location via the amodal bbox
        amodal = rle.decode(rle.merge(
            rle.fr_poly_objects([ann['segmentation']], h, w)))
        bbox = mask_to_bbox(amodal)
    else:
        bbox = mask_to_bbox(modal)
    return modal, bbox, 1


# ---------------------------------------------------------------------------
# a tiny COCO instances index (replaces pycocotools.coco.COCO for the two
# lookups the reference uses: loadImgs / loadAnns by id)
# ---------------------------------------------------------------------------

class CocoIndex:
    def __init__(self, annot_fn):
        with open(annot_fn) as f:
            data = json.load(f)
        self.imgs = {im['id']: im for im in data['images']}
        self.anns = {an['id']: an for an in data['annotations']}

    def load_img(self, img_id):
        return self.imgs[img_id]

    def load_ann(self, ann_id):
        return self.anns[ann_id]


# ---------------------------------------------------------------------------
# InstaOrder
# ---------------------------------------------------------------------------

class InstaOrderReader:
    """InstaOrder_{train,val}2017.json + COCO instances index."""

    def __init__(self, annot_fn, coco_annot_fn=None):
        with open(annot_fn) as f:
            self.annot_info = json.load(f)['annotations']
        if coco_annot_fn is None:
            for dtype in ('train2017', 'val2017'):
                if dtype in annot_fn:
                    coco_annot_fn = os.path.join(
                        os.path.dirname(annot_fn),
                        f'instances_{dtype}.json')
        self.coco = CocoIndex(coco_annot_fn)

    def get_image_length(self):
        return len(self.annot_info)

    def get_instance_length(self):
        self.indexing = [(i, k) for i, ann in enumerate(self.annot_info)
                         for k in range(len(ann['instance_ids']))]
        return len(self.indexing)

    def get_occlusion_length(self):
        self.occ_all_img_and_idx = [
            (i, k) for i, ann in enumerate(self.annot_info)
            for k in range(len(ann['occlusion']))]
        return len(self.occ_all_img_and_idx)

    def get_geometric_length(self):
        self.depth_all_img_and_order = [
            (i, d['order']) for i, ann in enumerate(self.annot_info)
            for d in ann['depth']]
        return len(self.depth_all_img_and_order)

    def get_imgId_and_depth(self, idx):
        return self.depth_all_img_and_order[idx]

    def get_gt_ordering(self, imgidx, type, rm_bidirec=0, rm_overlap=0):
        assert type in ('depth', 'occlusion')
        num = len(self.annot_info[imgidx]['instance_ids'])
        if type == 'occlusion':
            occ = np.zeros((num, num), int)
            for o in self.annot_info[imgidx]['occlusion']:
                order = o['order']
                if '&' in order:
                    # NB: with rm_bidirec the reference marks -1 using
                    # *stale* idx1/idx2 from the previous record (a latent
                    # bug at reader.py:345-349, unreachable in shipped
                    # configs which set remove_occ_bidirec: 0); we parse
                    # the current record's indices — the evident intent.
                    i1, i2 = map(int, order.split(' & ')[0].split('<'))
                    if rm_bidirec:
                        occ[i1, i2] = occ[i2, i1] = -1
                    else:
                        occ[i1, i2] = occ[i2, i1] = 1
                else:
                    i1, i2 = map(int, order.split('<'))
                    occ[i1, i2] = 1
            return occ
        depth = -np.ones((num, num), int)
        overlap = -np.ones((num, num), int)
        count = -np.ones((num, num), int)
        for d in self.annot_info[imgidx]['depth']:
            order = d['order']
            sep = '<' if '<' in order else '='
            i1, i2 = map(int, order.split(sep))
            if rm_overlap and d['overlap']:
                overlap[i1, i2] = overlap[i2, i1] = -1
            else:
                ov = 1 if d['overlap'] else 0
                overlap[i1, i2] = overlap[i2, i1] = ov
            if sep == '<':
                depth[i1, i2], depth[i2, i1] = 1, 0
            else:
                depth[i1, i2] = depth[i2, i1] = 2
            count[i1, i2] = count[i2, i1] = d['count']
        return [depth, overlap, count]

    def get_instance(self, idx, with_gt=False):
        imgidx, regidx = self.indexing[idx]
        ann_info = self.annot_info[imgidx]
        img_info = self.coco.load_img(ann_info['image_id'])
        h, w = img_info['height'], img_info['width']
        ann = self.coco.load_ann(int(ann_info['instance_ids'][regidx]))
        modal, bbox, category = read_LVIS(ann, h, w)
        return modal, bbox, category, img_info['file_name'], None

    def get_image_instances(self, idx, with_id=False, with_gt=False,
                            with_anns=False, ignore_stuff=False):
        ann_info = self.annot_info[idx]
        img_info = self.coco.load_img(ann_info['image_id'])
        h, w = img_info['height'], img_info['width']
        modals, bboxes, cats = [], [], []
        for ann_id in (int(a) for a in ann_info['instance_ids']):
            modal, bbox, cat = read_LVIS(self.coco.load_ann(ann_id), h, w)
            modals.append(modal)
            bboxes.append(bbox)
            cats.append(cat)
        base = (np.array(modals), np.array(cats), np.array(bboxes),
                np.array([]), img_info['file_name'])
        if with_anns:
            return base + (ann_info, ann_info['image_id'])
        if with_id:
            return base + (ann_info['image_id'],)
        return base


# ---------------------------------------------------------------------------
# COCOA
# ---------------------------------------------------------------------------

class COCOAReader:
    def __init__(self, annot_fn):
        with open(annot_fn) as f:
            data = json.load(f)
        self.images_info = data['images']
        self.annot_info = data['annotations']
        self.indexing = [(i, j) for i, ann in enumerate(self.annot_info)
                         for j in range(len(ann['regions']))]

    def get_instance_length(self):
        return len(self.indexing)

    def get_image_length(self):
        return len(self.images_info)

    def get_gt_ordering(self, imgidx):
        """depth_constraint "1-2,..." -> occluder matrix, skipping
        occludees with occlude_rate > 0.95 (reader.py:226-241)."""
        regions = self.annot_info[imgidx]['regions']
        num = len(regions)
        gt = np.zeros((num, num), int)
        order_str = self.annot_info[imgidx]['depth_constraint']
        if len(order_str) == 0:
            return gt
        for o in order_str.split(','):
            i1, i2 = (int(v) - 1 for v in o.split('-'))
            if regions[i2]['occlude_rate'] > 0.95:
                continue
            gt[i1, i2] = 1
        return gt

    def get_instance(self, idx, with_gt=False):
        imgidx, regidx = self.indexing[idx]
        img_info = self.images_info[imgidx]
        h, w = img_info['height'], img_info['width']
        reg = self.annot_info[imgidx]['regions'][regidx]
        modal, bbox, category = read_COCOA(reg, h, w)
        amodal = None
        if with_gt:
            amodal = rle.decode(rle.merge(
                rle.fr_poly_objects([reg['segmentation']], h, w)))
        return modal, bbox, category, img_info['file_name'], amodal

    def get_image_instances(self, idx, with_id=False, with_gt=False,
                            with_anns=False, ignore_stuff=False):
        ann_info = self.annot_info[idx]
        img_info = self.images_info[idx]
        h, w = img_info['height'], img_info['width']
        modals, bboxes, cats, amodals = [], [], [], []
        for reg in ann_info['regions']:
            if ignore_stuff and reg['isStuff']:
                continue
            modal, bbox, cat = read_COCOA(reg, h, w)
            modals.append(modal)
            bboxes.append(bbox)
            cats.append(cat)
            if with_gt:
                amodals.append(rle.decode(rle.merge(
                    rle.fr_poly_objects([reg['segmentation']], h, w))))
        base = (np.array(modals), np.array(cats), np.array(bboxes),
                np.array(amodals), img_info['file_name'])
        if with_anns:
            return base + (ann_info, img_info['id'])
        if with_id:
            return base + (img_info['id'],)
        return base


# ---------------------------------------------------------------------------
# KINS / LVIS
# ---------------------------------------------------------------------------

class KINSLVISReader:
    def __init__(self, dataset, annot_fn):
        self.dataset = dataset
        with open(annot_fn) as f:
            data = json.load(f)
        self.images_info = data['images']
        self.annot_info = data['annotations']
        self.category_info = data['categories']
        self.imgfn_dict = {a['id']: a['file_name'] for a in self.images_info}
        self.size_dict = {a['id']: (a['width'], a['height'])
                          for a in self.images_info}
        self.anns_dict = {}
        for ann in self.annot_info:
            self.anns_dict.setdefault(ann['image_id'], []).append(ann)
        self.img_ids = list(self.anns_dict.keys())

    def get_instance_length(self):
        return len(self.annot_info)

    def get_image_length(self):
        return len(self.img_ids)

    def _read(self, ann, h, w):
        if self.dataset == 'KINS':
            modal, bbox, category, _ = read_KINS(ann)
        elif self.dataset == 'LVIS':
            modal, bbox, category = read_LVIS(ann, h, w)
        else:
            raise ValueError(f"No such dataset: {self.dataset}")
        return modal, bbox, category

    def get_instance(self, idx, with_gt=False):
        ann = self.annot_info[idx]
        w, h = self.size_dict[ann['image_id']]
        modal, bbox, category = self._read(ann, h, w)
        amodal = None
        if with_gt:
            amodal = np.squeeze(rle.decode(rle.merge(
                rle.fr_poly_objects(ann['segmentation'], h, w))))
        return modal, bbox, category, self.imgfn_dict[ann['image_id']], amodal

    def get_image_instances(self, idx, with_gt=False, with_anns=False):
        imgid = self.img_ids[idx]
        w, h = self.size_dict[imgid]
        anns = self.anns_dict[imgid]
        modals, bboxes, cats, amodals = [], [], [], []
        for ann in anns:
            modal, bbox, cat = self._read(ann, h, w)
            modals.append(modal)
            bboxes.append(bbox)
            cats.append(cat)
            if with_gt:
                amodals.append(np.squeeze(rle.decode(rle.merge(
                    rle.fr_poly_objects(ann['segmentation'], h, w)))))
        base = (np.array(modals), np.array(cats), np.array(bboxes),
                np.array(amodals), self.imgfn_dict[imgid])
        if with_anns:
            return base + (anns,)
        return base


# registry mirroring the reference's dataset-name dispatch
READERS = {
    'InstaOrder': InstaOrderReader,
    'COCOA': COCOAReader,
    'KINS': lambda fn: KINSLVISReader('KINS', fn),
    'LVIS': lambda fn: KINSLVISReader('LVIS', fn),
}


# ---------------------------------------------------------------------------
# Mapillary
# ---------------------------------------------------------------------------

class MapillaryReader:
    """Mapillary Vistas: `annot_fn` lists each image's regions
    (instance_id, category_id); the instance map
    `{root}/instances/{image_id}.png` holds instance_id = category * 256 +
    instance at each pixel. No ground-truth order or amodal masks."""

    def __init__(self, root, annot_fn):
        with open(annot_fn) as f:
            annot = json.load(f)
        self.categories = annot['categories']
        self.annot_info = annot['images']
        self.root = root
        self.indexing = [(i, j) for i, ann in enumerate(self.annot_info)
                         for j in range(len(ann['regions']))]

    def get_instance_length(self):
        return len(self.indexing)

    def get_image_length(self):
        return len(self.annot_info)

    def _instance_map(self, image_id):
        return read_gray(f'{self.root}/instances/{image_id}.png').astype(
            np.uint16)

    def get_instance(self, idx, with_gt=False):
        if with_gt:
            raise ValueError('Mapillary Vistas has no ground truth for '
                             'ordering / amodal masks')
        imgidx, regidx = self.indexing[idx]
        image_id = self.annot_info[imgidx]['image_id']
        inst_map = self._instance_map(image_id)
        reg = self.annot_info[imgidx]['regions'][regidx]
        modal = (inst_map == reg['instance_id']).astype(np.uint8)
        return (modal, np.array(mask_to_bbox(modal)), reg['category_id'],
                image_id + '.jpg', None)

    def get_image_instances(self, idx, with_gt=False, with_anns=False,
                            ignore_stuff=False):
        """Every id of the map (background 0 included), as the
        reference: (modal (K, H, W), ids // 256, bboxes, None, file)."""
        if with_gt or ignore_stuff:
            raise ValueError('Mapillary Vistas has no ground truth, and '
                             'no stuff filter')
        image_id = self.annot_info[idx]['image_id']
        inst_map = self._instance_map(image_id)
        ids = np.unique(inst_map)
        modal = (ids[:, None, None] == inst_map[None]).astype(np.uint8)
        bboxes = [mask_to_bbox(m) for m in modal]
        return (modal, ids // 256, np.array(bboxes), None,
                image_id + '.jpg')


# ---------------------------------------------------------------------------
# dense-depth eval readers (KITTI / NYU / DIW)
# ---------------------------------------------------------------------------

def _normalize_chw(image, mean, std):
    """(H, W, 3) uint8 -> (3, H, W) normalised; float64 when mean / std
    are Python lists, as the JAX package's (the YAMLs' data_mean)."""
    x = image.transpose(2, 0, 1).astype(np.float32) / 255.0
    return ((x - np.asarray(mean)[:, None, None])
            / np.asarray(std)[:, None, None])


class KITTIReader:
    """Eval only: bottom-centre crop to 352x1216 + normalise
    (reader.py:69-96). Yields (image CHW, image path, depth path)."""

    def __init__(self, annot_file, image_root, data_mean, data_std):
        with open(annot_file) as f:
            self.filenames = f.readlines()
        self.image_root = image_root
        self.mean, self.std = data_mean, data_std

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, idx):
        parts = self.filenames[idx].split()
        img_name = f"{self.image_root}/rawdata/{parts[0]}"
        image = read_rgb(img_name)
        top = int(image.shape[0] - 352)
        left = int((image.shape[1] - 1216) / 2)
        image = image[top:top + 352, left:left + 1216, :]
        image = _normalize_chw(image, self.mean, self.std)
        depth_name = f"{self.image_root}/data_depth_annotated/{parts[1]}"
        return image, img_name, depth_name


class NYUReader:
    """Eval only: the image resized to 384x384 (cv2 INTER_LINEAR) +
    normalise. Yields (image CHW, image path, depth path)."""

    def __init__(self, annot_file, image_root, data_mean, data_std):
        with open(annot_file) as f:
            self.filenames = f.readlines()
        self.image_root = image_root
        self.mean, self.std = data_mean, data_std

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, idx):
        parts = self.filenames[idx].split()
        img_name = f"{self.image_root}/{parts[0]}"
        image = resize_linear_u8(read_rgb(img_name), 384, 384)
        image = _normalize_chw(image, self.mean, self.std)
        return image, img_name, f"{self.image_root}/{parts[1]}"


class DIWReader:
    """DIW csv of (image, A point, B point, ordinal) rows
    (reader.py:126-206). Yields (raw img, normalised 384x384 CHW,
    [[Ay, Ax], [By, Bx], ordinal], filename); the csv's 1-indexed points
    come out 0-indexed."""

    def __init__(self, annot_file, image_root, data_mean, data_std):
        with open(annot_file) as f:
            self.rows = list(csv.reader(f))
        self.image_root = image_root
        self.mean, self.std = data_mean, data_std
        self.n = len(self.rows) // 2

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        fn = self.rows[2 * idx][0]
        fn = f"{self.image_root}/{fn[1:]}" if fn.startswith('.') else fn
        img = read_rgb(fn)
        image = resize_linear_u8(img, 384, 384)
        image = _normalize_chw(image, self.mean, self.std)
        line = self.rows[2 * idx + 1]
        a_yx = [int(line[0]) - 1, int(line[1]) - 1]
        b_yx = [int(line[2]) - 1, int(line[3]) - 1]
        ordinal = line[4][0]
        return img, image, [a_yx, b_yx, ordinal], fn
