"""Dataset generation entry point (counterpart of smpl_nerf_tpu/cli/dataset.py).

    python create_dataset_torch.py --dataset_type=smpl_nerf --save_dir=data ... [--device cuda]

The flags of `config.dataset_config_parser` (the JAX generator's), plus
--device: the generator renders and runs LBS on the card unless `--device cpu`
asks for the host.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE


def main(argv: Optional[Sequence[str]] = None):
    from smpl_nerf_tpu_torch.config import dataset_config_parser
    from smpl_nerf_tpu_torch.data.generate import create_dataset

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu")
    own, rest = p.parse_known_args(argv)
    parser = dataset_config_parser()
    args = parser.parse_args(rest)
    return create_dataset(args, parser, device=own.device)


if __name__ == "__main__":
    main()
