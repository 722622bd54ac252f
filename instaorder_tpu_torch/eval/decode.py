"""Batched occlusion-order decoding (counterpart of
instaorder_tpu/eval/decode.py: `occ_pair_probs`, `decode_occ`,
`occ_matrix`).

  occlusion (InstaOrderNet_o): prob_i_over_j = (sig(out1)[:, 1] +
  sig(out2)[:, 0]) / 2 > 0.5 — out1 column 0 is "j over i", column 1 is
  "i over j". out2=None is single-direction serving (no swap average).
"""

from __future__ import annotations

import torch


def occ_pair_probs(out1, out2=None):
    """(P, 2) logits -> (prob_i_over_j, prob_j_over_i), each (P,)."""
    s1 = torch.sigmoid(out1)
    if out2 is None:
        return s1[:, 1], s1[:, 0]
    s2 = torch.sigmoid(out2)
    return (s1[:, 1] + s2[:, 0]) / 2.0, (s1[:, 0] + s2[:, 1]) / 2.0


def decode_occ(out1, out2=None, th=0.5):
    """-> (P,) bool i_over_j, (P,) bool j_over_i."""
    p_ij, p_ji = occ_pair_probs(out1, out2)
    return p_ij > th, p_ji > th


def occ_matrix(n, pair_idx, i_over_j, j_over_i, valid):
    """Scatter pair decisions into the (N, N) int32 occlusion matrix."""
    pair_idx = torch.as_tensor(pair_idx, dtype=torch.long,
                               device=i_over_j.device)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=i_over_j.device)
    m = torch.zeros((n, n), dtype=torch.int32, device=i_over_j.device)
    flat = m.view(-1)
    iv = (valid & i_over_j).to(torch.int32)
    jv = (valid & j_over_i).to(torch.int32)
    flat.scatter_reduce_(0, pair_idx[:, 0] * n + pair_idx[:, 1], iv, 'amax')
    flat.scatter_reduce_(0, pair_idx[:, 1] * n + pair_idx[:, 0], jv, 'amax')
    return m
