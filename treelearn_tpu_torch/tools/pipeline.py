"""Segmentation pipeline CLI of the PyTorch/CUDA port:

    python -m treelearn_tpu_torch.tools.pipeline --config configs/pipeline/pipeline.yaml

Counterpart of tools/pipeline.py (reference tools/pipeline/pipeline.py).
Runs on the card by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels.
"""

import argparse

from ..config import get_config
from ..pipeline import run_treelearn_pipeline


def main(argv=None):
    parser = argparse.ArgumentParser("treelearn_tpu_torch pipeline")
    parser.add_argument("--config", type=str, help="path to pipeline config")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    config = get_config(args.config)
    result = run_treelearn_pipeline(config, args.config, device=args.device)
    print(result)
    return result


if __name__ == "__main__":
    main()
