"""STB preprocessing with the PyTorch port (counterpart of
scripts/create_stb_db.py; reference tool/create_STB_DB.py:436-455).
Host work only, so it takes no --device.

    python -m mmhand_torch.scripts.create_stb_db SRC DST [SIZE] \\
        [--workers 8] [--limit N]

SRC is the STB root (``labels/*.mat`` and one folder per sequence); DST
gets ``train/`` (B1-B3, B5, B6) and ``test/`` (B4), the crop trees that
``--dataset STB`` reads.
"""

from __future__ import annotations

import argparse

from mmhand_torch.data.preprocess import create_stb_db


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("src")
    parser.add_argument("dst")
    parser.add_argument("size", type=int, nargs="?", default=256)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    counts = create_stb_db(args.src, args.dst, args.size,
                           workers=args.workers, limit=args.limit)
    print(f"wrote {counts} crops to {args.dst}")
    return counts


if __name__ == "__main__":
    main()
