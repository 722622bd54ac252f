"""PCNet-M order inference and amodal completion (counterpart of the part
of instaorder_tpu/eval/amodal.py that its Tester reaches: `resize_mask`,
`recover_mask`, `patch_to_fullimage`, `get_neighbors`, `get_ancestors`
and `AmodalCompleter` with `infer_order` and `infer_amodal`).

Reference inference.py:
  net_forward (softmax > th decode)        <- :22-41
  infer_order (erase-and-complete votes)   <- :627-688
  get_neighbors / get_ancestors            <- :805-822
  infer_amodal                             <- :885-926
  infer_amodal_hull (convex-hull baseline) <- :239-251
  infer_instseg (bbox prompts, denseCRF)   <- :825-857
  recover_mask / resize_mask / patch_to_fullimage <- :217-236, 929-933

The patches of a call go through the UNet in chunks of PATCH_CHUNK (one
forward each, eval-mode BatchNorm, so a patch's output does not depend
on its chunk): an image of N instances has N(N-1) patches, and a 256^2
patch of unet2 holds ~40 MiB of activations. The crops, resizes and
votes run on the host in numpy, as in the JAX package: the nearest
resizes through `ops.resize.resize_nearest_np`, the 'linear' mask resize
as an f32 half-pixel resize then > 0.5 (cv2's float path), the RGB
patch of a *res net through `resize_cubic_u8`, fed un-normalised as the
JAX package feeds it. The graph walks (ancestors) stay on the host, and
so do the convex hulls (`heuristics.convex_hull_image`, scipy) and the
mean-field CRF of `infer_instseg` (`ops.crf.densecrf`, numpy / scipy).
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import tree_to
from ..device import resolve_device
from ..ops.morphology import bordering_matrix
from ..ops.resize import resize, resize_cubic_u8, resize_nearest_np
from ..utils.geometry import crop_padding, dilate_square
from .heuristics import convex_hull_image

# patches per forward: bounds the activations of one call (~2.5 GiB for
# unet2 at 256^2), whatever the number of instances
PATCH_CHUNK = 64


def resize_mask(mask, size, interp):
    if interp == 'linear':
        x = torch.from_numpy(np.ascontiguousarray(mask, np.float32))
        return (resize(x, size, size, 'linear').numpy() > 0.5
                ).astype(np.uint8)
    return resize_nearest_np(mask, size, size)


def recover_mask(mask, bbox, h, w, interp):
    m = resize_mask(mask, bbox[2], interp)
    return crop_padding(m, [-bbox[0], -bbox[1], w, h], pad_value=(0,))


def patch_to_fullimage(patches, bboxes, height, width, interp):
    return np.array([recover_mask(p, b, height, width, interp)
                     for p, b in zip(patches, bboxes)])


def get_neighbors(graph, idx):
    return np.where(graph[idx, :] != 0)[0]


def get_ancestors(graph, idx):
    """BFS over `graph[q, :] == -1` edges (cycle-safe),
    reference inference.py:809-822."""
    is_anc = np.zeros(graph.shape[0], bool)
    visited = np.zeros(graph.shape[0], bool)
    queue = {idx}
    while queue:
        q = queue.pop()
        if visited[q]:
            continue
        visited[q] = True
        new_anc = np.where(graph[q, :] == -1)[0]
        is_anc[new_anc] = True
        queue.update(new_anc.tolist())
    is_anc[idx] = False
    return np.where(is_anc)[0]


class AmodalCompleter:
    """Batched PCNet-M completion on `device` (None: the card).

    apply_fn(params, stats, cfg, x[, rgb=]) -> logits NHWC (a registry
    entry's `apply`). Patches are (B, sz, sz, 2): [modal * category,
    eraser]."""

    def __init__(self, apply_fn, cfg, params, stats, use_rgb=False,
                 input_size=256, device=None):
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.cfg = cfg
        self.params = tree_to(params, self.device)
        self.stats = tree_to(stats, self.device)
        self.use_rgb = use_rgb
        self.input_size = input_size

    @torch.no_grad()
    def _predict_prob(self, modal_patches, eraser_patches, rgb_patches):
        """A batch of host patches -> (B, sz, sz) P(class=1) array, one
        forward per PATCH_CHUNK patches."""
        x = np.stack([np.stack([m, e], -1) for m, e in
                      zip(modal_patches, eraser_patches)]).astype(np.float32)
        rgb = (np.stack(rgb_patches).astype(np.float32) if self.use_rgb
               else None)
        out = []
        for i in range(0, len(x), PATCH_CHUNK):
            xb = torch.from_numpy(x[i:i + PATCH_CHUNK]).to(self.device)
            kw = ({'rgb': torch.from_numpy(rgb[i:i + PATCH_CHUNK]).to(
                self.device)} if self.use_rgb else {})
            logits = self.apply_fn(self.params, self.stats, self.cfg, xb,
                                   **kw)
            out.append(torch.softmax(logits, dim=-1)[..., 1].cpu())
        return torch.cat(out).numpy()

    def _predict(self, modal_patches, eraser_patches, rgb_patches, th):
        """A batch of host patches -> (B, sz, sz) uint8 amodal patches."""
        prob = self._predict_prob(modal_patches, eraser_patches, rgb_patches)
        return (prob > th).astype(np.uint8)

    def _patches(self, inmodal, eraser_full, bbox, category, image,
                 dilate_kernel, input_size, min_input_size, interp):
        """(modal * category, eraser, rgb or None, ratio) of one instance
        patch: its mask and the eraser cropped to `bbox`, resized, the
        eraser (dilated) cut out of the mask."""
        patch = crop_padding(inmodal, bbox, pad_value=(0,))
        newsize = (input_size if input_size is not None else
                   (min_input_size if min_input_size > bbox[2] else None))
        eraser = crop_padding(eraser_full, bbox, pad_value=(0,))
        if newsize is not None:
            patch = resize_mask(patch, newsize, interp)
            eraser = resize_mask(eraser, newsize, interp)
        if dilate_kernel > 0:
            eraser = dilate_square(eraser, dilate_kernel)
        patch = patch.copy()
        patch[eraser == 1] = 0
        rgb = None
        if self.use_rgb:
            sz = patch.shape[0]
            rgb = resize_cubic_u8(crop_padding(image, bbox,
                                               pad_value=(0, 0, 0)), sz, sz)
        ratio = 1.0 if newsize is None else bbox[2] / float(newsize)
        return patch * category, eraser, rgb, ratio

    def infer_order(self, image, inmodal, category, bboxes, pairs='all',
                    th=0.5, dilate_kernel=0, input_size=None,
                    min_input_size=32, interp='nearest'):
        """Erase-and-complete occlusion voting (inference.py:627-688):
        for each ordered pair (t, e), erase e's mask from t's patch,
        complete it, count the newly explained pixels under the eraser
        (scaled by the resize ratio^2); the larger vote wins the
        pair."""
        num = inmodal.shape[0]
        order = np.zeros((num, num), int)
        if pairs == 'nbor':
            border = bordering_matrix(torch.as_tensor(
                np.asarray(inmodal), device=self.device)).cpu().numpy()
        ind = []
        for i in range(num):
            for j in range(i + 1, num):
                if pairs == 'nbor' and not border[i, j]:
                    continue
                ind.append([i, j])
                ind.append([j, i])
        if not ind:
            return order
        modal_ps, eraser_ps, rgb_ps, ratios = [], [], [], []
        for tid, eid in ind:
            m, e, rgb, ratio = self._patches(
                inmodal[tid], inmodal[eid], bboxes[tid], category[tid],
                image, dilate_kernel, input_size, min_input_size, interp)
            modal_ps.append(m)
            eraser_ps.append(e)
            rgb_ps.append(rgb)
            ratios.append(ratio)
        amodal_ps = self._predict(modal_ps, eraser_ps, rgb_ps, th)
        occ_value = np.zeros((num, num), np.float32)
        for k, (t, e) in enumerate(ind):
            occ_value[t, e] = (((amodal_ps[k] > modal_ps[k])
                                & (eraser_ps[k] == 1)).sum()
                               * ratios[k] ** 2)
        order[occ_value > occ_value.T] = 0
        order[occ_value < occ_value.T] = 1
        order[(occ_value == 0) & (occ_value == 0).T] = 0
        return order

    def infer_amodal(self, image, inmodal, category, bboxes, order_matrix,
                     th=0.5, dilate_kernel=0, input_size=None,
                     min_input_size=16, interp='nearest',
                     order_grounded=True):
        """Ancestor-union erase + complete per instance
        (inference.py:885-926)."""
        num = inmodal.shape[0]
        modal_ps, eraser_ps, rgb_ps = [], [], []
        for i in range(num):
            anc = (get_ancestors(order_matrix, i) if order_grounded
                   else get_neighbors(order_matrix, i))
            eraser = (inmodal[anc, ...].sum(axis=0) > 0).astype(np.uint8)
            m, e, rgb, _ = self._patches(
                inmodal[i], eraser, bboxes[i], category[i], image,
                dilate_kernel, input_size, min_input_size, interp)
            modal_ps.append(m)
            eraser_ps.append(e)
            rgb_ps.append(rgb)
        return list(self._predict(modal_ps, eraser_ps, rgb_ps, th))


def infer_amodal_hull(inmodal, bboxes, order_matrix, order_grounded=True):
    """Convex-hull amodal baseline (inference.py:239-251): each modal
    mask's filled convex hull, cut (order_grounded) to the mask and its
    ancestors' union. bboxes is unused, as in the reference."""
    out = []
    for i in range(inmodal.shape[0]):
        m = inmodal[i]
        hull = convex_hull_image(m).astype(np.uint8)
        if order_grounded:
            if order_matrix is None:
                raise ValueError('order_grounded needs an order_matrix')
            anc = get_ancestors(order_matrix, i)
            eraser = (inmodal[anc, ...].sum(axis=0) > 0).astype(np.uint8)
            hull[(eraser == 0) & (m == 0)] = 0
        out.append(hull)
    return out


def infer_instseg(completer, image, category, bboxes, new_bboxes,
                  input_size, th, rgb=None):
    """Instance segmentation from bbox prompts (inference.py:825-857):
    each bbox as a mask inside its crop `new_bboxes[i]`, resized to
    input_size (nearest), through the completer with an all-zero eraser,
    the class-1 probability thresholded at th. With `rgb` (H, W, 3)
    uint8 given, one mean-field step of the dense CRF (ops/crf.densecrf)
    on [1 - p, p] over the crop's cubic-resized RGB comes first.
    Returns a list of (input_size, input_size) uint8 masks."""
    num = bboxes.shape[0]
    modal_ps, eraser_ps, rgb_ps = [], [], []
    for i in range(num):
        rel = [bboxes[i][0] - new_bboxes[i][0],
               bboxes[i][1] - new_bboxes[i][1], bboxes[i][2], bboxes[i][3]]
        bbox_mask = np.zeros((new_bboxes[i][3], new_bboxes[i][2]), np.uint8)
        bbox_mask[rel[1]:rel[1] + rel[3], rel[0]:rel[0] + rel[2]] = 1
        bbox_mask = resize_nearest_np(bbox_mask, input_size, input_size)
        modal_ps.append(bbox_mask.astype(np.float32) * category[i])
        eraser_ps.append(np.zeros_like(bbox_mask, np.float32))
        if completer.use_rgb:
            rgb_ps.append(resize_cubic_u8(
                crop_padding(image, new_bboxes[i], pad_value=(0, 0, 0)),
                input_size, input_size))
    if rgb is None:
        return list(completer._predict(modal_ps, eraser_ps, rgb_ps, th))
    from ..ops.crf import densecrf
    probs = completer._predict_prob(modal_ps, eraser_ps, rgb_ps)
    out = []
    for i in range(num):
        rgb_patch = resize_cubic_u8(
            crop_padding(rgb, new_bboxes[i], pad_value=(0, 0, 0)),
            input_size, input_size)
        prob = np.stack([1.0 - probs[i], probs[i]])
        prob_crf = densecrf(prob, rgb_patch)
        out.append((prob_crf[1] > th).astype(np.uint8))
    return out
