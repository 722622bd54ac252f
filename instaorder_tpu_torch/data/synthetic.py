"""Synthetic-annotation fixtures (counterpart of
instaorder_tpu/data/synthetic.py: the three fixture writers), the
dense-disparity eval's (DIW, KITTI, NYU) and Mapillary's (the JAX
package has none of these four).

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

# KITTI's image size (the eval crops 352x1216 from its bottom centre)
KITTI_HW = (375, 1242)
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


# ---------------------------------------------------------------------------
# dense-disparity eval fixtures (data/readers.DIWReader / KITTIReader /
# NYUReader): the tests' and chip_smoke's data, not a user feature
# ---------------------------------------------------------------------------

def _scene_rgb(rng, h, w):
    """A uint8 RGB image: a vertical ramp per channel under noise, so a
    resize has structure to interpolate."""
    ramp = np.linspace(0, 200, h, dtype=np.float32)[:, None, None]
    tint = rng.uniform(0.3, 1.0, 3).astype(np.float32)
    noise = rng.randint(0, 56, (h, w, 3)).astype(np.float32)
    return np.clip(ramp * tint + noise, 0, 255).astype(np.uint8)


def _depth_png(rng, h, w, max_depth, keep):
    """A uint16 (depth * 256) map: a ground plane whose depth grows toward
    a horizon at 40% of the height (nothing above it), up to max_depth
    metres, with a share `keep` of its pixels kept (0 = no measurement,
    as in KITTI's projected LiDAR)."""
    y = np.arange(h, dtype=np.float64)[:, None] - 0.4 * h
    depth = np.where(y > 0, np.minimum(max_depth, 0.02 * h * max_depth
                                       / np.maximum(y, 1e-9)), 0.0)
    depth = np.broadcast_to(depth, (h, w)) * rng.uniform(0.9, 1.1, (h, w))
    depth = np.where(rng.rand(h, w) < keep, depth, 0.0)
    return np.clip(np.rint(depth * 256.0), 0, 65535).astype(np.uint16)


def make_diw_fixture(root, n_images=8, seed=3):
    """DIW: PNG images of mixed sizes under {root}/DIW_test/ and
    {root}/DIW_Annotations/DIW_test.csv in the reference's two-row layout
    (a row with the image path, './DIW_test/<name>', relative to the
    image root; then 'yA,xA,yB,xB,ordinal,width,height', 1-indexed, the
    ordinal '<' when A is closer, else '>', drawn at random). Returns
    (csv path, image root)."""
    rng = np.random.RandomState(seed)
    sizes = ((240, 320), (480, 640), (300, 400), (500, 333))
    os.makedirs(os.path.join(root, 'DIW_test'), exist_ok=True)
    os.makedirs(os.path.join(root, 'DIW_Annotations'), exist_ok=True)
    rows = []
    for i in range(n_images):
        h, w = sizes[i % len(sizes)]
        name = f'DIW_test/diw_{i:04d}.png'
        write_png(os.path.join(root, name), _scene_rgb(rng, h, w))
        ya, yb = rng.choice(np.arange(1, h + 1), 2, replace=False)
        xa, xb = rng.randint(1, w + 1, 2)
        rows.append(f'./{name}\n')
        rows.append(f'{ya},{xa},{yb},{xb},{"<>"[rng.randint(2)]},'
                    f'{w},{h}\n')
    path = os.path.join(root, 'DIW_Annotations', 'DIW_test.csv')
    with open(path, 'w') as f:
        f.writelines(rows)
    return path, root


def make_kitti_fixture(root, n_images=4, seed=4, keep=0.3):
    """KITTI (Eigen split layout): RGB PNGs of KITTI_HW under
    {root}/rawdata/, 16-bit depth PNGs (depth * 256, 0 where LiDAR has
    no return: a share 1 - keep of the pixels) under
    {root}/data_depth_annotated/, and the file list
    {root}/train_test_inputs/eigen_test_files_with_gt.txt ('image depth
    focal' lines). Returns (file list path, image root)."""
    rng = np.random.RandomState(seed)
    h, w = KITTI_HW
    drive = '2011_09_26_drive_0002_sync'
    lines = []
    for i in range(n_images):
        img = f'2011_09_26/{drive}/image_02/data/{i:010d}.png'
        dep = f'{drive}/proj_depth/groundtruth/image_02/{i:010d}.png'
        for sub, rel, arr in (
                ('rawdata', img, _scene_rgb(rng, h, w)),
                ('data_depth_annotated', dep,
                 _depth_png(rng, h, w, 80.0, keep))):
            full = os.path.join(root, sub, rel)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            write_png(full, arr)
        lines.append(f'{img} {dep} 721.5377\n')
    path = os.path.join(root, 'train_test_inputs',
                        'eigen_test_files_with_gt.txt')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        f.writelines(lines)
    return path, root


def make_nyu_fixture(root, n_images=2, h=480, w=640, seed=5):
    """NYU: RGB PNGs of h x w and 16-bit depth PNGs (depth * 256, up to
    10 m, 5% holes) under {root}/nyu/, and the file list
    {root}/nyu_test_files_with_gt.txt ('image depth focal' lines). The
    depth maps are 384x384, the size NYUReader resizes the image to:
    eval_dense_depth compares the prediction with the ground truth
    pixel for pixel, with no resize (as the JAX package's). Returns
    (file list path, image root)."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, 'nyu'), exist_ok=True)
    lines = []
    for i in range(n_images):
        img, dep = f'nyu/rgb_{i:05d}.png', f'nyu/depth_{i:05d}.png'
        write_png(os.path.join(root, img), _scene_rgb(rng, h, w))
        write_png(os.path.join(root, dep),
                  _depth_png(rng, 384, 384, 10.0, 0.95))
        lines.append(f'{img} {dep} 518.8579\n')
    path = os.path.join(root, 'nyu_test_files_with_gt.txt')
    with open(path, 'w') as f:
        f.writelines(lines)
    return path, root


def make_mapillary_fixture(root, n_images=4, n_instances=4, h=96, w=128,
                           seed=6):
    """Mapillary Vistas layout under {root}/mapillary/: 16-bit instance
    maps instances/<id>.png (each pixel category * 256 + instance, 0
    where no instance: layered rectangles, later ones on top), RGB images
    images/<id>.jpg, and annotations.json listing each image's regions
    (instance_id, category_id) and the categories. The images are PNG
    data under the reader's `.jpg` names (image_io.read_rgb and PIL
    both go by the file's signature), so no JPEG encoder is needed.
    Returns (annotation path, the reader's root, image root)."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, 'mapillary')
    for sub in ('instances', 'images'):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    images = []
    for i in range(n_images):
        image_id = f'map_{i:04d}'
        inst = np.zeros((h, w), np.uint16)
        regions = []
        for k in range(n_instances):
            hh, ww = rng.randint(h // 4, h // 2), rng.randint(w // 4, w // 2)
            y0, x0 = rng.randint(0, h - hh), rng.randint(0, w - ww)
            cat = int(rng.randint(1, 60))
            iid = cat * 256 + k
            inst[y0:y0 + hh, x0:x0 + ww] = iid
            regions.append({'instance_id': iid, 'category_id': cat})
        # a region wholly covered by later ones is not in the map
        present = set(np.unique(inst).tolist())
        regions = [r for r in regions if r['instance_id'] in present]
        write_png(os.path.join(base, 'instances', f'{image_id}.png'), inst)
        write_png(os.path.join(base, 'images', f'{image_id}.jpg'),
                  _scene_rgb(rng, h, w))
        images.append({'image_id': image_id, 'regions': regions})
    path = os.path.join(base, 'annotations.json')
    with open(path, 'w') as f:
        json.dump({'categories': [{'id': c} for c in range(1, 60)],
                   'images': images}, f)
    return path, base, os.path.join(base, 'images')
