"""Batched per-image order inference (counterpart of
instaorder_tpu/eval/pipeline.py: `OrderPredictor` and its factories
`make_folded_predictor`, `make_int8_predictor`, `make_v2_predictor`, and
`DisparityOrderPredictor`).

One image plus its N instance masks in, the (N, N) occlusion and/or
depth matrices out:

  1. host: the (padded) upper-triangle pair list, and for pairs='nbor'
     the bordering filter;
  2. device: the (P, sz, sz, 5) pair batch (patch / image / resize / orig
     mode), the forward over both swap directions (or one), decode, and
     the scatter into the matrices.

Pair counts are padded to the next of PAIR_BUCKETS and 'orig' images to
the next HW_BUCKET_STEP multiple, as in the JAX package, so the card sees
a handful of shapes and the padded pairs (index (0, 0)) are computed and
then dropped through `valid`. There is no jit: PyTorch runs eagerly.

`DisparityOrderPredictor` orders the instances by a disparity map
(MiDaS): one forward an image, the region depths on the device, the pair
loop on the host.

Pair sharding (`mesh=`, the JAX package's shard_map over the `data`
axis): the forward's batch, the padded 2P pairs (or the siamese P), is
split into contiguous equal chunks, one for each device of the mesh (a
list of devices, parallel/mesh.make_mesh); each device holds its own
copy of the trees (the card-built kernel weights included) and runs its
chunk, and the outputs are gathered in order on the first device. The
prep and the decode stay on the first device, unsharded, as in JAX.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import inspect

import numpy as np
import torch

from ..convert import tree_to
from ..core.nn import tree_cast
from ..device import resolve_device
from ..models import quantize as Q
from ..models.folding import (add_f32_block_weights, add_stem_kernel_weights,
                              apply_folded, apply_folded_siamese,
                              fold_resnet)
from ..ops.morphology import bordering_matrix
from ..ops.pairs import (_normalize, all_pair_indices, build_pair_batch,
                         build_pair_batch_rois, build_pair_batch_shared_rgb,
                         build_pair_batches_fused, pair_rois)
from ..ops.resize import resize, resize_nearest
from ..utils.geometry import get_closest_int_multiple_of
from . import decode as D

PAIR_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)

# 'orig' mode pads the x32-rounded image to the next multiple of this
# step and hands the net the valid region (resnet.apply valid_hw)
HW_BUCKET_STEP = 128

MODES = ('patch', 'image', 'resize', 'orig')


def bucket_pairs(p: int) -> int:
    for b in PAIR_BUCKETS:
        if p <= b:
            return b
    return int(np.ceil(p / PAIR_BUCKETS[-1]) * PAIR_BUCKETS[-1])


def bucket_hw(v: int) -> int:
    return max(HW_BUCKET_STEP,
               int(np.ceil(v / HW_BUCKET_STEP) * HW_BUCKET_STEP))


def _swap_input(x):
    """Swap the two mask channels of a (P, H, W, 5) batch."""
    return x[..., [1, 0, 2, 3, 4]]


class OrderPredictor:
    """Batched equivalent of the reference's infer_order_sup_{occ,depth,
    occ_depth}.

    apply_fn(params, stats, cfg, x[, valid_hw=(vh, vw)]) returns the
    LOGITS of a (B, sz, sz, C) batch: (B, 2) or (B, {3, 4}) for a single
    head, ((B, 2), (B, 3)) for the dual occlusion / depth head. (The JAX
    package's apply_fn returns a (logits, stats) pair and takes
    train=False; the port's forwards are eval-only.) siamese_fn(params,
    stats, cfg, x) returns (out1, out2), both swap directions from the
    un-swapped batch (the folded-conv1 trick of models/folding), and is
    used at directions=2 in every mode but a bucket-padded 'orig' batch.

    patch_or_image: 'patch' (per-pair union-bbox square crops, cubic),
    'image' (the whole image padded to a square, linear), 'resize' (one
    shared full-image cubic resize) or 'orig' (the image at its own
    size rounded to x32, zero-padded to the next HW_BUCKET_STEP bucket
    with valid_hw when apply_fn takes it). directions: 2 averages both
    mask orders (reference parity), 1 runs one forward per pair (an
    occlusion-only serving knob). use_rgb=False feeds the two mask
    channels only.

    prep_impl: 'einsum' (the cv2-exact tap-gather prep, f32) or
    'pallas5' (patch mode only): the 5-channel prep kernel
    (ops/prep_kernels.fused_prep_pairs) at prep_passes (3 or 1), writing
    prep_dtype (default torch.float32; torch.bfloat16 for the bf16, v2
    and int8c predictors).

    device: None -> the card (device.resolve_device, which also pins
    TF32 off), or 'cpu' for the plain versions. params and stats are
    moved there. mesh: a list of devices (the first one takes the place
    of `device`) to shard the forward's pair batch over (module
    docstring); a batch that does not divide by its size raises, as
    JAX's shard_map does. The infer_* methods take the image (H, W, 3)
    float in [0, 255], masks (N, H, W) {0, 1} and bboxes (N, 4) xywh as
    numpy arrays, upload them once per call (the image as f32, the masks
    as uint8) and return numpy int32 matrices.
    """

    def __init__(self, apply_fn, cfg, params, stats, method,
                 patch_or_image='patch', input_size=256, use_rgb=True,
                 directions=2, siamese_fn=None, prep_impl='einsum',
                 prep_passes=3, prep_dtype=None, device=None, mesh=None):
        if patch_or_image not in MODES:
            raise ValueError(f'patch_or_image must be one of {MODES}')
        if directions not in (1, 2):
            raise ValueError(f'directions must be 1 or 2, got {directions}')
        if prep_impl not in ('einsum', 'pallas5'):
            raise ValueError(f'unknown prep_impl {prep_impl!r}')
        if prep_impl == 'pallas5' and patch_or_image != 'patch':
            raise ValueError("prep_impl='pallas5' supports patch mode "
                             "only (image/resize/orig share one RGB crop "
                             "across pairs: nothing to fuse)")
        self.mesh = None if mesh is None else [resolve_device(d)
                                                for d in mesh]
        self.device = resolve_device(device) if mesh is None \
            else self.mesh[0]
        self.apply_fn = apply_fn
        self.cfg = cfg
        self.params = tree_to(params, self.device)
        self.stats = tree_to(stats, self.device)
        # each mesh device's copy of the trees (one copy per distinct
        # device)
        self._replicas = None if mesh is None else {
            d: (tree_to(self.params, d), tree_to(self.stats, d))
            for d in dict.fromkeys(self.mesh)}
        self.method = method
        self.patch_or_image = patch_or_image
        self.input_size = input_size
        self.use_rgb = use_rgb
        self.directions = directions
        self.siamese_fn = siamese_fn
        self.prep_impl = prep_impl
        self.prep_passes = prep_passes
        self.prep_dtype = prep_dtype or torch.float32
        try:
            self._takes_valid_hw = ('valid_hw' in
                                    inspect.signature(apply_fn).parameters)
        except (TypeError, ValueError):
            self._takes_valid_hw = False

    def to(self, device):
        """The same predictor, unsharded, with its trees on `device` (e.g.
        'cpu', to hold the card's matrices against the plain versions)."""
        other = copy.copy(self)
        other.mesh = other._replicas = None
        other.device = resolve_device(device)
        other.params = tree_to(self.params, other.device)
        other.stats = tree_to(self.stats, other.device)
        return other

    def _sharded(self, fn, x):
        """fn(params, stats, x) over the mesh: x's rows in len(mesh)
        contiguous equal chunks, chunk k on mesh device k with its copy
        of the trees, the outputs (tensors, or tuples of them, nested)
        gathered in order on the first device; fn on the trees as they
        are without a mesh."""
        if self.mesh is None:
            return fn(self.params, self.stats, x)
        n, k = int(x.shape[0]), len(self.mesh)
        if n % k:
            raise ValueError(f'a batch of {n} does not divide over the '
                             f'{k}-device mesh')
        outs = []
        for d, part in zip(self.mesh, x.split(n // k)):
            # the chunk's device made current once for its whole forward,
            # so that the kernel wrappers need no switch of their own
            with (torch.cuda.device(d) if d.type == 'cuda'
                  else contextlib.nullcontext()):
                outs.append(fn(*self._replicas[d], part.to(d)))

        def gather(parts):
            if isinstance(parts[0], tuple):
                return tuple(gather(p) for p in zip(*parts))
            return torch.cat([p.to(self.device) for p in parts])
        return gather(outs)

    def _forward(self, x, valid_hw=None):
        if valid_hw is not None:
            return self._sharded(lambda p, s, xs: self.apply_fn(
                p, s, self.cfg, xs, valid_hw=valid_hw), x)
        return self._sharded(
            lambda p, s, xs: self.apply_fn(p, s, self.cfg, xs), x)

    def _build_batch(self, image, masks, bboxes, pair_idx):
        """-> (x, valid_hw): the (P, h, w, 5) pair batch on the device and
        the valid region of an 'orig' bucket-padded batch (else None).
        image (H, W, 3) f32, masks (N, H, W) uint8, bboxes (N, 4) f32
        tensors; pair_idx a (P, 2) int32 numpy array."""
        sz = self.input_size
        mode = self.patch_or_image
        if mode == 'patch':
            if self.prep_impl == 'pallas5':
                rois = pair_rois(bboxes, pair_idx)
                return build_pair_batches_fused(
                    image[None], masks[None], pair_idx,
                    rois[None].contiguous(), out_size=sz,
                    passes=self.prep_passes, fuse_masks=True,
                    dtype=self.prep_dtype), None
            return build_pair_batch(image, masks, bboxes, pair_idx,
                                    out_size=sz, rgb_method='cubic'), None
        if mode == 'image':
            # pad to a square: one shared roi centred on the image
            h, w = image.shape[:2]
            side = max(h, w)
            roi = torch.tensor([-((side - w) // 2), -((side - h) // 2),
                                side, side], dtype=torch.float32,
                               device=image.device)
            rois = roi.expand(pair_idx.shape[0], 4)
            return build_pair_batch_rois(image, masks, pair_idx, rois,
                                         out_size=sz,
                                         rgb_method='linear'), None
        if mode == 'resize':
            return build_pair_batch_shared_rgb(image, masks, pair_idx,
                                               out_size=sz,
                                               rgb_method='cubic'), None
        # 'orig': the image size rounded to x32, zero-padded up to the
        # (h, w) bucket with the valid region beside it (the JAX package
        # pads so one compiled program covers a bucket; the port keeps
        # the same padded tensor)
        h = get_closest_int_multiple_of(int(image.shape[0]), 32)
        w = get_closest_int_multiple_of(int(image.shape[1]), 32)
        rgb = resize(image.permute(2, 0, 1), h, w, 'cubic').permute(1, 2, 0)
        rgb = _normalize(torch.clamp(torch.round(rgb), 0.0, 255.0))
        masks_r = resize_nearest(masks.float(), h, w)
        pidx = torch.as_tensor(pair_idx, dtype=torch.long,
                               device=image.device)
        P = pidx.shape[0]
        x = torch.cat([masks_r[pidx[:, 0], ..., None],
                       masks_r[pidx[:, 1], ..., None],
                       rgb[None].expand(P, h, w, 3)], dim=-1)
        if not self._takes_valid_hw:
            return x, None
        hb, wb = bucket_hw(h), bucket_hw(w)
        if (hb, wb) != (h, w):
            x = torch.nn.functional.pad(x, (0, 0, 0, wb - w, 0, hb - h))
        return x, (h, w)

    @torch.no_grad()
    def pair_outputs(self, image, masks, bboxes, pairs='all'):
        """The forward over every (padded) pair of one image: (pair_idx
        (P, 2) numpy, valid (P,) bool tensor, out1, out2, n). out1 is the
        (i, j) direction's logits (a tuple for a dual head), out2 the
        swapped direction's, None at directions=1."""
        if pairs not in ('all', 'nbor'):
            raise ValueError(f"pairs must be 'all' or 'nbor', got {pairs!r}")
        dev = self.device
        n = int(masks.shape[0])
        p = n * (n - 1) // 2
        pair_idx, valid = all_pair_indices(n, bucket_pairs(max(p, 1)))
        image = torch.as_tensor(np.asarray(image), dtype=torch.float32,
                                device=dev)
        masks = torch.as_tensor(np.asarray(masks), device=dev).to(
            torch.uint8)
        bboxes = torch.as_tensor(np.asarray(bboxes, np.float32), device=dev)
        if pairs == 'nbor' and n > 1:
            bm = bordering_matrix(masks).cpu().numpy()
            valid = valid & bm[pair_idx[:, 0], pair_idx[:, 1]]
        valid = torch.as_tensor(valid, device=dev)
        x1, valid_hw = self._build_batch(image, masks, bboxes, pair_idx)
        if (self.directions == 2 and self.siamese_fn is not None
                and valid_hw is None and self.use_rgb):
            out1, out2 = self._sharded(
                lambda p, s, xs: self.siamese_fn(p, s, self.cfg, xs), x1)
            return pair_idx, valid, out1, out2, n
        x = x1 if self.directions == 1 else torch.cat(
            [x1, _swap_input(x1)], dim=0)
        if not self.use_rgb:
            x = x[..., :2]
        out = self._forward(x, valid_hw)
        if self.directions == 1:
            return pair_idx, valid, out, None, n
        P = pair_idx.shape[0]
        if isinstance(out, tuple):
            return (pair_idx, valid, tuple(o[:P] for o in out),
                    tuple(o[P:] for o in out), n)
        return pair_idx, valid, out[:P], out[P:], n

    def _occ(self, pair_idx, valid, out1, out2, n):
        if self.method == 'OrderNet':
            i_over_j, j_over_i = D.decode_ordernet(out1, out2)
        elif self.method == 'InstaOrderNet_o':
            i_over_j, j_over_i = D.decode_occ(out1, out2)
        elif self.method in ('InstaOrderNet_od', 'InstaDepthNet_od'):
            head = lambda o: o[0] if isinstance(o, tuple) else o
            i_over_j, j_over_i = D.decode_occ(
                head(out1), None if out2 is None else head(out2))
        else:
            raise ValueError(self.method)
        return D.occ_matrix(n, pair_idx, i_over_j, j_over_i,
                            valid).cpu().numpy()

    @staticmethod
    def _depth(pair_idx, valid, out1, out2, n):
        tail = lambda o: o[1] if isinstance(o, tuple) else o
        arg = D.decode_depth(tail(out1), None if out2 is None else tail(out2))
        return D.depth_matrix(n, pair_idx, arg, valid).cpu().numpy()

    @torch.no_grad()
    def infer_occ_order(self, image, masks, bboxes, pairs='all'):
        """-> (N, N) int32 occlusion matrix."""
        return self._occ(*self.pair_outputs(image, masks, bboxes, pairs))

    @torch.no_grad()
    def infer_depth_order(self, image, masks, bboxes, pairs='all'):
        """-> (N, N) int32 depth matrix."""
        return self._depth(*self.pair_outputs(image, masks, bboxes, pairs))

    @torch.no_grad()
    def infer_occ_depth_order(self, image, masks, bboxes, pairs='all'):
        """-> (occ (N, N), depth (N, N)) from a dual-head net."""
        pair_idx, valid, out1, out2, n = self.pair_outputs(
            image, masks, bboxes, pairs)
        occ1, dep1 = out1
        occ2, dep2 = out2 if out2 is not None else (None, None)
        occ = D.occ_matrix(n, pair_idx, *D.decode_occ(occ1, occ2), valid)
        dep = D.depth_matrix(n, pair_idx, D.decode_depth(dep1, dep2), valid)
        return occ.cpu().numpy(), dep.cpu().numpy()


def _folded_fn(forward, p, s, c, x, **kw):
    """A factory's apply_fn / siamese_fn: forward(p, c, x, **kw) of a
    folded or quantized tree (no statistics); a partial of this is
    picklable, so a predictor moved to the CPU can be sent to another
    process."""
    return forward(p, c, x, **kw)


def _calib(calib_batches, dev):
    return [torch.as_tensor(c, dtype=torch.float32, device=dev)
            for c in calib_batches]


def make_folded_predictor(params, stats, cfg, method, dtype=None,
                          use_pallas=False, device=None, **kw):
    """OrderPredictor over a BN-folded ResNet (models/folding): dtype None
    is the f32 strict-parity predictor, torch.bfloat16 the serving one.
    use_pallas: the kernel feature set (False, True = the default
    `identity`, or names of models/folding.PALLAS_VOCAB); the f32 model
    runs the kernels' f32 modes, and without kernels the plain chain
    (the cuDNN f32 route on the card, TF32 off).

    On the card the model gets the stem kernel's weights in its dtype
    (add_stem_kernel_weights), and at f32 every block the f32 block
    kernel's split K-major weights (add_f32_block_weights), as
    serving.build_parity_model and build_f32_model do."""
    dev = resolve_device(device)
    folded = fold_resnet(tree_to(params, dev), tree_to(stats, dev), cfg)
    if dtype is not None:
        folded = tree_cast(folded, dtype)
    if dev.type == 'cuda':
        add_stem_kernel_weights(folded['conv1'])
        if folded['conv1']['w'].dtype == torch.float32:
            add_f32_block_weights(folded)

    return OrderPredictor(
        functools.partial(_folded_fn, apply_folded, dtype=dtype,
                          use_pallas=use_pallas), cfg, folded, stats,
        method, siamese_fn=functools.partial(
            _folded_fn, apply_folded_siamese, dtype=dtype,
            use_pallas=use_pallas), device=dev, **kw)


def make_int8_predictor(params, stats, cfg, method, calib_batches,
                        use_pallas=True, device=None, **kw):
    """The fully quantized (int8c) OrderPredictor (models/quantize):
    BN-fold, calibrate the activation scales on `calib_batches` (a list
    of prep-normalised (B, sz, sz, C) f32 arrays or tensors), quantize,
    and serve int8 throughout; use_pallas: the int8c feature set
    (default `identity,down`). On the card the model gets the K-major
    block and stem kernel weights (quantize.add_kernel_weights)."""
    dev = resolve_device(device)
    folded = fold_resnet(tree_to(params, dev), tree_to(stats, dev), cfg)
    scales = Q.calibrate_folded_resnet(folded, cfg, _calib(calib_batches,
                                                           dev))
    qp = Q.quantize_folded_resnet(folded, cfg, scales)
    if dev.type == 'cuda':
        Q.add_kernel_weights(qp)

    return OrderPredictor(
        functools.partial(_folded_fn, Q.apply_folded_int8,
                          use_pallas=use_pallas), cfg, qp, stats, method,
        siamese_fn=functools.partial(_folded_fn, Q.apply_folded_int8_siamese,
                                     use_pallas=use_pallas),
        device=dev, **kw)


def make_v2_predictor(params, stats, cfg, method, calib_batches,
                      use_pallas=True, compute_dtype=None, device=None,
                      **kw):
    """The boundary-int8 (v2) OrderPredictor (models/quantize
    quantize_folded_v2): BN-fold, calibrate the boundary scales on
    `calib_batches`, then serve int8 block boundaries with compute_dtype
    (default bf16) inside the blocks; use_pallas: the v2 feature set
    (default `hwnc,down2,hwncs1d,dirpack`). The JAX factory's TPU-only
    knobs (conv2_mode, hwnc_io, pipeline, stage_unroll) do not carry
    over. On the card the model gets the stem kernel's weights in its
    compute dtype (add_stem_kernel_weights), which the `stem` feature's
    q8 stem reads, and at compute_dtype=f32 every block the f32 block
    kernel's split K-major weights (add_f32_block_weights)."""
    dev = resolve_device(device)
    cdt = torch.bfloat16 if compute_dtype is None else compute_dtype
    folded = fold_resnet(tree_to(params, dev), tree_to(stats, dev), cfg)
    scales = Q.calibrate_folded_resnet(folded, cfg, _calib(calib_batches,
                                                           dev))
    qp = Q.quantize_folded_v2(folded, cfg, scales, compute_dtype=cdt)
    if dev.type == 'cuda':
        add_stem_kernel_weights(qp['conv1'])
        if cdt == torch.float32:
            add_f32_block_weights(qp)

    return OrderPredictor(
        functools.partial(_folded_fn, Q.apply_folded_v2,
                          use_pallas=use_pallas), cfg, qp, stats, method,
        siamese_fn=functools.partial(_folded_fn, Q.apply_folded_v2_siamese,
                                     use_pallas=use_pallas),
        device=dev, **kw)


class DisparityOrderPredictor:
    """Depth order from a disparity map (reference net_forward_midas_
    pretrained and the disp_select_method branch of infer_order_sup_depth,
    inference.py:79-104, 582-605): the disparity once per image, each
    instance's region depth (decode.region_depths of 1 / (disp + 1e-6)
    inside its mask), then every pair compared.

    forward: a (1, sz, sz, 3) normalised NHWC f32 tensor on `device` ->
    (1, h', w') disparity tensor (eval/disp.make_disp_forward). device:
    None is the card (device.resolve_device), 'cpu' the CPU. It has no
    infer_occ_depth_order, as the JAX package's has none.
    """

    def __init__(self, forward, select_method='median', input_size=384,
                 device=None):
        assert select_method in ('mean', 'median')
        self.forward = forward
        self.select = select_method
        self.input_size = input_size
        self.device = resolve_device(device)

    def infer_depth_order(self, image, masks, bboxes=None, pairs='all',
                          return_disp=False):
        """image (H, W, 3) in [0, 255], masks (N, H, W) {0, 1} (numpy) ->
        the (N, N) depth matrix (numpy int). return_disp: also the
        disparity clipped to its [q05, q95] (numpy; the reference's
        second return, inference.py:588,601,624). bboxes are unused (the
        signature of OrderPredictor.infer_depth_order)."""
        dev, sz = self.device, self.input_size
        img = torch.as_tensor(np.asarray(image, np.float32), device=dev)
        rgb = resize(img.permute(2, 0, 1), sz, sz, 'cubic').permute(1, 2, 0)
        rgb = _normalize(torch.clamp(torch.round(rgb), 0.0, 255.0))
        with torch.no_grad():
            disp = self.forward(rgb[None])[0]
        disp_clipped = None
        if return_disp:
            flat = disp.reshape(-1)
            lo, hi = torch.quantile(flat, 0.05), torch.quantile(flat, 0.95)
            disp_clipped = torch.clamp(disp, lo, hi).cpu().numpy()
        m = torch.as_tensor(np.asarray(masks, np.uint8), device=dev)
        masks_r = resize_nearest(m.float(), disp.shape[0], disp.shape[1])
        depths = D.region_depths(1.0 / (disp + 1e-6), masks_r > 0.5,
                                 self.select).cpu().numpy()
        n = masks.shape[0]
        order = np.zeros((n, n), int)
        if pairs == 'nbor' and n > 1:
            border = bordering_matrix(m).cpu().numpy()
        for i in range(n):
            for j in range(i + 1, n):
                if pairs == 'nbor' and not border[i, j]:
                    continue
                if depths[i] < depths[j]:
                    order[i, j], order[j, i] = 1, 0
                elif depths[i] > depths[j]:
                    order[i, j], order[j, i] = 0, 1
                else:
                    order[i, j] = order[j, i] = 2
        if return_disp:
            return order, disp_clipped
        return order
