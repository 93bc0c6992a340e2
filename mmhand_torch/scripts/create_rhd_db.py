"""RHD preprocessing with the PyTorch port (counterpart of
scripts/create_rhd_db.py; reference tool/create_RHD_DB.py:306-403).
Host work only, so it takes no --device.

    python -m mmhand_torch.scripts.create_rhd_db SRC DST [SIZE] \\
        [--split evaluation] [--workers 8] [--limit N]

SRC is the RHD root (``<split>/anno_<split>.pickle`` and
``<split>/{color,depth,mask}/``); DST gets the crop tree that
``--dataset RHD`` reads.
"""

from __future__ import annotations

import argparse

from mmhand_torch.data.preprocess import create_rhd_db


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("src")
    parser.add_argument("dst")
    parser.add_argument("size", type=int, nargs="?", default=256)
    parser.add_argument("--split", default="evaluation",
                        choices=["training", "evaluation"])
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    n = create_rhd_db(args.src, args.dst, args.size, split=args.split,
                      workers=args.workers, limit=args.limit)
    print(f"wrote {n} crops to {args.dst}")
    return n


if __name__ == "__main__":
    main()
