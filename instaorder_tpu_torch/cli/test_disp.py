"""Dense-disparity eval CLI (counterpart of instaorder_tpu/cli/test_disp.py;
the reference's tools/test_disp_DIW.py and tools/test_disp_KITTI.py),
plus --device.

    python -m instaorder_tpu_torch.cli.test_disp --config \
        experiments/DIW/midas_pretrained/config.yaml \
        [--load_model ckpt_iter_N.ckpt] [--test_num N] [--device cpu]

The config's data.dataset picks the flow: diw (WHDR over the annotated
point pairs) or kitti / nyu (the 8 dense-depth metrics). --device: 'cuda'
(the default) runs on the card; 'cpu' on the CPU. Reading the YAML needs
PyYAML. --load_model takes the port's own checkpoints or a torch .pt /
.pth.tar / .pth state_dict (compat/torch_convert.convert_checkpoint).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', required=True)
    ap.add_argument('--load_model', default=None)
    ap.add_argument('--test_num', default=-1, type=int)
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = ap.parse_args(argv)

    from .config import load_config
    from ..data import readers as R
    from ..eval.disp import eval_dense_depth, eval_diw, make_disp_forward

    cfg = load_config(args.config)
    data = cfg.data
    dataset = data['dataset'].lower()
    if dataset not in ('diw', 'kitti', 'nyu'):
        raise ValueError(dataset)
    fwd = make_disp_forward(cfg.model['algo'], args.load_model,
                            features=cfg.model.get('features', 256),
                            device=args.device)
    if dataset == 'diw':
        reader = R.DIWReader(data['val_annot_file'], data['val_image_root'],
                             data['data_mean'], data['data_std'])
        out = eval_diw(fwd, reader, n_samples=args.test_num)
    else:
        cls = R.KITTIReader if dataset == 'kitti' else R.NYUReader
        reader = cls(data['val_annot_file'], data['val_image_root'],
                     data['data_mean'], data['data_std'])
        out = eval_dense_depth(fwd, reader, dataset,
                               n_samples=args.test_num)
    print(out)
    return out


if __name__ == '__main__':
    main()
