"""Batched order decoding (counterpart of instaorder_tpu/eval/decode.py:
`occ_pair_probs`, `decode_occ`, `decode_ordernet`, `decode_depth`,
`occ_matrix`, `depth_matrix`).

  occlusion (InstaOrderNet_o): prob_i_over_j = (sig(out1)[:, 1] +
  sig(out2)[:, 0]) / 2 > 0.5 — out1 column 0 is "j over i", column 1 is
  "i over j". out2=None is single-direction serving (no swap average).
  OrderNet: argmax of the averaged (p_1over2, p_2over1, p_none, p_both),
  p_both = 0 for the 3-class head.
  depth: argmax of the averaged (closer, farther, equal).

Matrices: occ[i, j] = 1 iff i over j; depth closer -> [i,j]=1, [j,i]=0,
farther -> [i,j]=0, [j,i]=1, equal -> both 2. Cells of padded or
filtered pairs (valid False) stay 0.
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


def decode_ordernet(out1, out2=None):
    """OrderNet softmax-average argmax -> (i_over_j, j_over_i) bools, for
    3- and 4-class heads (the 4th class is "both")."""
    s1 = torch.softmax(out1, dim=-1)
    four = out1.shape[-1] == 4
    if out2 is None:
        p12, p21, pno = s1[:, 1], s1[:, 0], s1[:, 2]
        pbo = s1[:, 3] if four else torch.zeros_like(p12)
    else:
        s2 = torch.softmax(out2, dim=-1)
        p12 = (s1[:, 1] + s2[:, 0]) / 2.0
        p21 = (s1[:, 0] + s2[:, 1]) / 2.0
        pno = (s1[:, 2] + s2[:, 2]) / 2.0
        pbo = (s1[:, 3] + s2[:, 3]) / 2.0 if four else torch.zeros_like(p12)
    arg = torch.argmax(torch.stack([p12, p21, pno, pbo], dim=1), dim=1)
    return (arg == 0) | (arg == 3), (arg == 1) | (arg == 3)


def decode_depth(out1, out2=None):
    """3-way depth argmax -> (P,) in {0: i closer, 1: i farther, 2: eq}."""
    s1 = torch.softmax(out1, dim=-1)
    if out2 is None:
        closer, farther, equal = s1[:, 0], s1[:, 1], s1[:, 2]
    else:
        s2 = torch.softmax(out2, dim=-1)
        closer = (s1[:, 0] + s2[:, 1]) / 2.0
        farther = (s1[:, 1] + s2[:, 0]) / 2.0
        equal = (s1[:, 2] + s2[:, 2]) / 2.0
    return torch.argmax(torch.stack([closer, farther, equal], dim=1), dim=1)


def depth_matrix(n, pair_idx, argidx, valid):
    """Scatter depth decisions into the (N, N) int32 depth matrix."""
    dev = argidx.device
    pair_idx = torch.as_tensor(pair_idx, dtype=torch.long, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    one, two = torch.ones_like(argidx), torch.full_like(argidx, 2)
    zero = torch.zeros_like(argidx)
    ij = torch.where(argidx == 0, one, torch.where(argidx == 2, two, zero))
    ji = torch.where(argidx == 1, one, torch.where(argidx == 2, two, zero))
    m = torch.zeros((n, n), dtype=torch.int32, device=dev)
    flat = m.view(-1)
    flat.scatter_reduce_(0, pair_idx[:, 0] * n + pair_idx[:, 1],
                         torch.where(valid, ij, zero).to(torch.int32), 'amax')
    flat.scatter_reduce_(0, pair_idx[:, 1] * n + pair_idx[:, 0],
                         torch.where(valid, ji, zero).to(torch.int32), 'amax')
    return m
