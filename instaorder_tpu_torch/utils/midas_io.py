"""MiDaS-style I/O utilities (counterpart of instaorder_tpu/utils/midas_io.py;
numpy only, cv2 imported at call time by `read_image` and
`write_depth_png`).

Parity with reference utils/utils_midas.py: PFM read/write, image read
with /255 RGB conversion, the inverse-depth PNG writer; and the MiDaS
Resize transform's sizing rules (utils/data_utils.py:37-53 +
midas/transforms.py:48-180).
"""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path):
    """-> (HxW[x3] float array flipped to top-down, scale)."""
    with open(path, 'rb') as f:
        header = f.readline().rstrip().decode('ascii')
        if header == 'PF':
            color = True
        elif header == 'Pf':
            color = False
        else:
            raise ValueError(f'Not a PFM file: {path}')
        dims = re.match(r'^(\d+)\s(\d+)\s$', f.readline().decode('ascii'))
        if not dims:
            raise ValueError('Malformed PFM header.')
        width, height = map(int, dims.groups())
        scale = float(f.readline().decode('ascii').rstrip())
        endian = '<' if scale < 0 else '>'
        scale = abs(scale)
        data = np.fromfile(f, endian + 'f')
        shape = (height, width, 3) if color else (height, width)
        return np.flipud(data.reshape(shape)), scale


def write_pfm(path, image, scale=1):
    with open(path, 'wb') as f:
        if image.dtype.name != 'float32':
            raise ValueError('Image dtype must be float32.')
        image = np.flipud(image)
        if image.ndim == 3 and image.shape[2] == 3:
            color = True
        elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
            color = False
        else:
            raise ValueError('Image must have H x W x {1, 3} dims.')
        f.write(b'PF\n' if color else b'Pf\n')
        f.write(f'{image.shape[1]} {image.shape[0]}\n'.encode('ascii'))
        endian = image.dtype.byteorder
        if endian == '<' or (endian == '=' and
                             np.little_endian):
            scale = -scale
        f.write(f'{scale}\n'.encode('ascii'))
        image.tofile(f)


def read_image(path):
    """RGB float in [0, 1] (utils_midas.read_image semantics)."""
    import cv2
    img = cv2.imread(path)
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def write_depth_png(path, depth, bits=1):
    """Normalized inverse-depth PNG (uint8/uint16) like utils_midas."""
    import cv2
    depth = np.asarray(depth, np.float64)
    dmin, dmax = depth.min(), depth.max()
    max_val = (2 ** (8 * bits)) - 1
    if dmax - dmin > np.finfo('float').eps:
        out = max_val * (depth - dmin) / (dmax - dmin)
    else:
        out = np.zeros_like(depth)
    cv2.imwrite(path, out.astype('uint16' if bits == 2 else 'uint8'))


def constrain_to_multiple_of(x, multiple_of=32, min_val=0, max_val=None):
    """MiDaS Resize.constrain_to_multiple_of (midas/transforms.py:89-99)."""
    y = (np.round(x / multiple_of) * multiple_of).astype(int)
    if max_val is not None and y > max_val:
        y = (np.floor(x / multiple_of) * multiple_of).astype(int)
    if y < min_val:
        y = (np.ceil(x / multiple_of) * multiple_of).astype(int)
    return int(y)


def midas_resize_shape(h, w, target_h, target_w, keep_aspect_ratio=False,
                       resize_method='upper_bound', multiple_of=32):
    """The (new_h, new_w) the MiDaS Resize transform would pick
    (midas/transforms.py:101-142)."""
    scale_h = target_h / h
    scale_w = target_w / w
    if keep_aspect_ratio:
        if resize_method == 'lower_bound':
            s = max(scale_h, scale_w)
        elif resize_method == 'upper_bound':
            s = min(scale_h, scale_w)
        else:  # minimal
            s = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h
        scale_h = scale_w = s
    if resize_method == 'lower_bound':
        nh = constrain_to_multiple_of(scale_h * h, multiple_of,
                                      min_val=target_h)
        nw = constrain_to_multiple_of(scale_w * w, multiple_of,
                                      min_val=target_w)
    elif resize_method == 'upper_bound':
        nh = constrain_to_multiple_of(scale_h * h, multiple_of,
                                      max_val=target_h)
        nw = constrain_to_multiple_of(scale_w * w, multiple_of,
                                      max_val=target_w)
    else:
        nh = constrain_to_multiple_of(scale_h * h, multiple_of)
        nw = constrain_to_multiple_of(scale_w * w, multiple_of)
    return nh, nw


def disp_to_depth(disp, min_depth, max_depth):
    """reference utils/common_utils.py:9-14."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def unnormalize(rgb_chw):
    """Invert imagenet normalization (common_utils.UnNormalize)."""
    mean = np.array([0.485, 0.456, 0.406])[:, None, None]
    std = np.array([0.229, 0.224, 0.225])[:, None, None]
    return rgb_chw * std + mean
