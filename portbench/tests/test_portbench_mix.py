"""The od.image instance-count multiset, its pair buckets and where its
95th percentile falls."""

import json
from pathlib import Path

import numpy as np

from instaorder_tpu_torch.eval.pipeline import bucket_pairs

MIX = json.loads((Path(__file__).resolve().parents[1] / 'traffic'
                  / 'image.json').read_text())


def test_multiset_shape():
    c = MIX['instance_counts']
    assert len(c) == 40 and min(c) == 2 and max(c) == 20
    assert c == sorted(c)
    assert 6.5 <= np.mean(c) <= 7.5          # COCO val2017: ~7 an image
    assert np.median(c) == 5                 # heavy-tailed: median < mean


def test_buckets_and_the_95th_percentile():
    c = MIX['instance_counts']
    b = [bucket_pairs(max(n * (n - 1) // 2, 1)) for n in c]
    shares = {k: b.count(k) / len(b) for k in sorted(set(b))}
    assert sorted(shares) == [8, 16, 32, 64, 128, 256]
    # the costliest bucket holds the top 10% of images: its share spans
    # the 90th to the 100th percentile, so the 95th lies inside it with
    # 5 points of room on each side
    assert shares[256] == 0.10
    lo = sum(v for k, v in shares.items() if k < 256)
    assert lo <= 0.95 - 0.05 + 1e-9 and 0.95 + 0.05 <= 1.0 + 1e-9
    pad = 1 - sum(n * (n - 1) // 2 for n in c) / sum(b)
    assert abs(pad - 0.3542) < 1e-4
