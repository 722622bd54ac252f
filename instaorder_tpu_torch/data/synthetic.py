"""Synthetic-annotation fixtures (counterpart of
instaorder_tpu/data/synthetic.py: the three fixture writers).

Generates a tiny, fully-valid InstaOrder/COCO dataset on disk — images,
`instances_val2017.json`, `InstaOrder_val2017.json` with coherent
occlusion + depth annotations — so reader/tester integration runs
without the real 2.9M-annotation dataset. The scenes are layered
rectangles: layer order defines both occlusion (who covers whom where they
overlap) and depth (closer = higher layer), giving ground truth the
evaluators can be checked against.

The random draws are the JAX package's, in the same order, so the
annotations (RLE, polygons, orders, depth and overlap) equal its
fixtures field for field. One difference: every image is written with
`image_io.write_png` as a `.png` file (and named so in the
annotations), where the JAX package writes the InstaOrder and COCOA
images as JPEG through PIL. The pixels are the canvas JAX hands to its
JPEG encoder, and no PIL is needed to write or read them.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import rle
from .image_io import write_png
from ..utils.geometry import mask_to_bbox


def make_instaorder_fixture(root, n_images=4, n_instances=4, h=96, w=128,
                            seed=0, split='val2017'):
    """Creates {root}/{split}/ images + {root}/annotations/ jsons.
    Returns (instaorder_json_path, instances_json_path, image_root)."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, split)
    ann_dir = os.path.join(root, 'annotations')
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    images, annotations, insta = [], [], []
    ann_id = 1
    for img_i in range(n_images):
        image_id = 1000 + img_i
        fn = f'{image_id:012d}.png'
        canvas = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        # layered rectangles, later = closer (occludes earlier)
        full = []     # unoccluded masks
        for k in range(n_instances):
            y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 50)
            hh, ww = rng.randint(20, 40), rng.randint(25, 50)
            m = np.zeros((h, w), np.uint8)
            m[y0:y0 + hh, x0:x0 + ww] = 1
            full.append(m)
            color = rng.randint(0, 255, 3)
            canvas[m == 1] = color
        visible = []
        for k in range(n_instances):
            vis = full[k].copy()
            for later in range(k + 1, n_instances):
                vis[full[later] == 1] = 0
            visible.append(vis)

        write_png(os.path.join(img_dir, fn), canvas)
        images.append({'id': image_id, 'file_name': fn, 'height': h,
                       'width': w})

        inst_ids = []
        for k in range(n_instances):
            r = rle.encode(visible[k])
            annotations.append({
                'id': ann_id, 'image_id': image_id,
                'segmentation': {'size': r['size'], 'counts': r['counts']},
                'bbox': [float(v) for v in
                         _bbox_of(visible[k])],
                'category_id': int(rng.randint(1, 10)),
                'area': int(visible[k].sum()), 'iscrowd': 0,
            })
            inst_ids.append(ann_id)
            ann_id += 1

        occlusion, depth = [], []
        for a in range(n_instances):
            for b in range(a + 1, n_instances):
                overlap = bool((full[a] & full[b]).any())
                if overlap:
                    # later index b occludes a -> "a < b" means a occluded
                    # by b in the reference's "i<j" = i-under... the
                    # reference stores occluder<occludee? get_gt_ordering
                    # sets gt[idx1, idx2] = 1 for "idx1<idx2" and the eval
                    # treats gt[i, j] == 1 as "i over j". Later = closer =
                    # occluder, so idx1 must be b.
                    occlusion.append({'order': f'{b}<{a}'})
                # depth: closer = higher layer; "i<j" = i closer than j
                depth.append({'order': f'{b}<{a}' if b > a else f'{a}<{b}',
                              'overlap': overlap,
                              'count': int(rng.randint(1, 4))})
        insta.append({'image_id': image_id, 'instance_ids': inst_ids,
                      'occlusion': occlusion, 'depth': depth})

    instances_path = os.path.join(ann_dir, f'instances_{split}.json')
    insta_path = os.path.join(ann_dir, f'InstaOrder_{split}.json')
    with open(instances_path, 'w') as f:
        json.dump({'images': images, 'annotations': annotations,
                   'categories': [{'id': i, 'name': f'c{i}'}
                                  for i in range(1, 10)]}, f)
    with open(insta_path, 'w') as f:
        json.dump({'annotations': insta}, f)
    return insta_path, instances_path, img_dir


def _bbox_of(mask):
    return mask_to_bbox(mask)


def make_cocoa_fixture(root, n_images=3, n_instances=3, h=64, w=80, seed=1,
                       split='val'):
    """Tiny COCOA-format fixture (regions with visible_mask RLE +
    depth_constraint strings)."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, f'cocoa_{split}')
    os.makedirs(img_dir, exist_ok=True)
    images, annots = [], []
    for img_i in range(n_images):
        image_id = 2000 + img_i
        fn = f'cocoa_{image_id}.png'
        canvas = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        full, visible = [], []
        for k in range(n_instances):
            y0, x0 = rng.randint(0, h - 24), rng.randint(0, w - 24)
            m = np.zeros((h, w), np.uint8)
            m[y0:y0 + rng.randint(12, 24), x0:x0 + rng.randint(12, 24)] = 1
            full.append(m)
        for k in range(n_instances):
            vis = full[k].copy()
            for later in range(k + 1, n_instances):
                vis[full[later] == 1] = 0
            visible.append(vis)
        write_png(os.path.join(img_dir, fn), canvas)
        images.append({'id': image_id, 'file_name': fn, 'height': h,
                       'width': w})
        regions = []
        constraints = []
        for k in range(n_instances):
            area_full = max(int(full[k].sum()), 1)
            occ_rate = 1.0 - visible[k].sum() / area_full
            # polygon of the full rect (amodal); visible mask as RLE
            ys, xs = np.nonzero(full[k])
            y0, y1, x0, x1 = ys.min(), ys.max(), xs.min(), xs.max()
            poly = [float(x0), float(y0), float(x1 + 1), float(y0),
                    float(x1 + 1), float(y1 + 1), float(x0), float(y1 + 1)]
            regions.append({'segmentation': poly,
                            'visible_mask': rle.encode(visible[k]),
                            'occlude_rate': float(occ_rate),
                            'isStuff': False})
        for a in range(n_instances):
            for b in range(a + 1, n_instances):
                if (full[a] & full[b]).any():
                    constraints.append(f'{b + 1}-{a + 1}')  # later occludes
        annots.append({'image_id': image_id, 'regions': regions,
                       'depth_constraint': ','.join(constraints),
                       'size': n_instances})
    path = os.path.join(root, f'COCOA_{split}.json')
    with open(path, 'w') as f:
        json.dump({'images': images, 'annotations': annots}, f)
    return path, img_dir


def make_kins_fixture(root, n_images=3, n_instances=3, h=80, w=120, seed=2,
                      split='val'):
    """Tiny KINS-format fixture: annotations carry `inmodal_seg` RLE,
    `inmodal_bbox`, and amodal polygon `segmentation` so the
    infer_gt_order path (modal ∩ amodal overlap) is exercised."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, f'kins_{split}')
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for img_i in range(n_images):
        image_id = 3000 + img_i
        fn = f'kins_{image_id}.png'
        canvas = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        full, visible = [], []
        for k in range(n_instances):
            y0, x0 = rng.randint(0, h - 30), rng.randint(0, w - 40)
            m = np.zeros((h, w), np.uint8)
            m[y0:y0 + rng.randint(16, 30), x0:x0 + rng.randint(20, 40)] = 1
            full.append(m)
        for k in range(n_instances):
            vis = full[k].copy()
            for later in range(k + 1, n_instances):
                vis[full[later] == 1] = 0
            visible.append(vis)
        write_png(os.path.join(img_dir, fn), canvas)
        images.append({'id': image_id, 'file_name': fn, 'height': h,
                       'width': w})
        for k in range(n_instances):
            ys, xs = np.nonzero(full[k])
            y0, y1, x0, x1 = ys.min(), ys.max(), xs.min(), xs.max()
            amodal_poly = [float(x0), float(y0), float(x1 + 1), float(y0),
                           float(x1 + 1), float(y1 + 1), float(x0),
                           float(y1 + 1)]
            annotations.append({
                'id': ann_id, 'image_id': image_id,
                'inmodal_seg': rle.encode(visible[k]),
                'inmodal_bbox': mask_to_bbox(visible[k]),
                'segmentation': [amodal_poly],
                'category_id': int(rng.randint(1, 5)),
                'area': int(visible[k].sum()), 'iscrowd': 0,
            })
            ann_id += 1
    path = os.path.join(root, f'KINS_{split}.json')
    with open(path, 'w') as f:
        json.dump({'images': images, 'annotations': annotations,
                   'categories': [{'id': i, 'name': f'c{i}'}
                                  for i in range(1, 5)]}, f)
    return path, img_dir
