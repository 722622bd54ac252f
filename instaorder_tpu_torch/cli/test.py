"""Eval CLI (counterpart of instaorder_tpu/cli/test.py) — the
reference's tools/test.py flags, plus --device.

    python -m instaorder_tpu_torch.cli.test --config \
        experiments/InstaOrder/InstaOrderNet_o/config.yaml \
        --load_model ckpt_iter_N.ckpt [--device cpu]

--device: 'cuda' (the default) runs on the card; 'cpu' runs the plain
versions (as the tests do). Reading the YAML needs PyYAML; a config with
`tensorboard: true` needs tensorboardX (see utils/telemetry.py).
--disp_select_method (median | mean) evaluates an InstaDepthNet through
its disparity, as midas_pretrained is evaluated. --save_pngs is not
ported yet and raises (ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', required=True)
    ap.add_argument('--load_model', default=None)
    ap.add_argument('--order_method', default='')
    ap.add_argument('--order_th', default=0.1, type=float)
    ap.add_argument('--amodal_th', default=0.2, type=float)
    ap.add_argument('--test_num', default=-1, type=int)
    ap.add_argument('--pairs', default='all', choices=['all', 'nbor'])
    ap.add_argument('--disp_select_method', default='')
    ap.add_argument('--save_pngs', default=0, type=int)
    ap.add_argument('--zd', default=0, type=int)
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = ap.parse_args(argv)

    from .config import load_config
    from ..eval.tester import Tester

    cfg = load_config(args.config)
    cfg.order_method = args.order_method
    cfg.load_model = args.load_model
    cfg.pairs = args.pairs
    cfg.zd = args.zd
    cfg.disp_select_method = args.disp_select_method
    cfg.save_pngs = args.save_pngs
    tester = Tester(cfg, n_images=args.test_num, device=args.device)
    out = tester.run()
    print(out)
    return out


if __name__ == '__main__':
    main()
