"""Multiply-accumulates and bytes of a ResNet-50, counted from its layer
shapes: every convolution and the head's matrix product, each MAC once
(BatchNorm, ReLU, pooling and additions are not counted, as torchvision
does not count them). At 3 x 224^2 with 1000 classes this gives
torchvision's 4.09 G.
"""

from __future__ import annotations

from .model import EXPANSION, LAYERS, PLANES


def _out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def resnet50_blocks(in_ch, h, w):
    """The stem conv and the 16 bottleneck blocks of a ResNet-50 on an
    (h, w, in_ch) input: a list of dicts with the layer's MACs for one
    image, its input and output activation elements and its weight
    elements ('stem' first, then 'layerL.B')."""
    ho, wo = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    out = [{'name': 'stem', 'macs': ho * wo * 64 * in_ch * 49,
            'in': h * w * in_ch, 'out': ho * wo * 64,
            'weights': 49 * in_ch * 64}]
    h, w = _out(ho, 3, 2, 1), _out(wo, 3, 2, 1)
    cin = 64
    for li, (planes, n) in enumerate(zip(PLANES, LAYERS)):
        for bi in range(n):
            s = 2 if li > 0 and bi == 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            cout = planes * EXPANSION
            wts = cin * planes + 9 * planes * planes + planes * cout
            macs = (h * w * cin * planes + ho * wo * 9 * planes * planes
                    + ho * wo * planes * cout)
            if s != 1 or cin != cout:
                wts += cin * cout
                macs += ho * wo * cin * cout
            out.append({'name': f'layer{li + 1}.{bi}', 'macs': macs,
                        'in': h * w * cin, 'out': ho * wo * cout,
                        'weights': wts})
            cin, h, w = cout, ho, wo
    return out


def resnet50_macs(in_ch, h, w, num_classes):
    """MACs of one forward of one image: every conv and the head(s);
    num_classes an int or a list (one head each)."""
    heads = sum(num_classes) if isinstance(num_classes, (list, tuple)) \
        else num_classes
    return (sum(b['macs'] for b in resnet50_blocks(in_ch, h, w))
            + 512 * EXPANSION * heads)
