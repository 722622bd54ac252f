"""PyTorch / CUDA port of instaorder_tpu for NVIDIA Hopper (H100).

The JAX package `instaorder_tpu` is the reference this package is held
against; nothing here imports it (or JAX). The first slice ports the
serving-d1 occlusion path: fused 5-channel pair prep, the boundary-int8
("v2") ResNet-50 trunk and the occlusion decode. Its four TPU kernels are
hand-written CUDA C++ under `csrc/`, built with nvcc at first use
(`ops/_build.py`) and bound through ctypes.

The per-image entry point, one image and its instance masks in and the
order matrices out, is `eval/pipeline.OrderPredictor` and its factories;
the evaluation harness over a dataset is `eval/tester.Tester` (`python
-m instaorder_tpu_torch.cli.test`), with the readers, RLE codec and
checkpoint I/O under `data/`, `native/` and `core/`.

Layouts follow the JAX package at every public function: activations
NHWC, conv weights HWIO, parameter trees nested dicts/lists with the JAX
keys. Entry points run on `cuda` unless the caller passes
`device='cpu'` (see `device.resolve_device`).
"""
