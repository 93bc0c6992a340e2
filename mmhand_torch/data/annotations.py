"""Annotation pickles and the augmentation-ratio split
(counterpart of mmhand_tpu/data/annotations.py; numpy only).

`annotation.pickle` maps {folder: {image_name: {K/k, uv_coord, xyz, depth}}}
(reference tool/create_RHD_DB.py:323-355, tool/create_STB_DB.py:393-419), so
datasets preprocessed by either package or the reference are interchangeable.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Optional

import numpy as np


def load_annotations(root_dir: str) -> dict:
    """reference data/generic_dataset.py:88-91."""
    with open(os.path.join(root_dir, "annotation.pickle"), "rb") as handle:
        return pickle.load(handle)


def save_annotations(root_dir: str, annotations: dict) -> None:
    with open(os.path.join(root_dir, "annotation.pickle"), "wb") as handle:
        pickle.dump(annotations, handle)


def split_src_tgt(data: list, ratio: float, *, is_train: bool, root_dir: str,
                  rng: np.random.Generator,
                  sort_fn: Optional[Callable] = None):
    """The `_get_src_tgt` split contract (reference
    data/generic_dataset.py:96-128):

    * a 'test' directory uses ALL images as targets (generation over the
      held-out set);
    * train mode keeps the LAST `ratio` fraction (mask[sep:] = True with
      sep = (1-ratio)*N);
    * generate mode (isTrain False on a train dir) takes the complement
      (first (1-ratio) fraction) — the images the GAN never saw, to be
      synthesized for augmentation;
    * sources are a shuffled copy of the targets (pairing fixed per epoch
      construction; the reference shuffles once at init with python
      `random` — here the caller passes a seeded Generator).
    """
    if not data:
        raise ValueError(f"no images to split under {root_dir!r}")
    data = sorted(data, key=sort_fn) if sort_fn is not None else list(data)
    sep = int((1.0 - ratio) * len(data))
    # Divergence: the reference substring-matches 'test' against the FULL
    # path (generic_dataset.py:114), which misfires on any parent directory
    # containing 'test'; we check only the leaf directory name.
    leaf = os.path.basename(os.path.normpath(root_dir))
    if "test" in leaf:
        tgt = data
    elif is_train:
        tgt = data[sep:]
    else:
        tgt = data[:sep]
    src = list(tgt)
    rng.shuffle(src)
    return src, tgt
