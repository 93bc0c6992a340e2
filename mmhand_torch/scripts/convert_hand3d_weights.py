"""Convert the reference's ColorHandPose3D TF pickles into the port's
pipeline checkpoint (the port's twin of tools/convert_hand3d_weights.py).

    python -m mmhand_torch.scripts.convert_hand3d_weights \\
        handsegnet-rhd.pickle posenet3d-rhd-stb-slr-finetuned.pickle \\
        --checkpoints_dir ./checkpoints --name hand3d

The reference ships its weights as pickled ``{tf_name: ndarray}`` dicts
(``HandSegNet/conv1_1/weights``, ``PosePrior/fc_rel0/biases``; reference
hand_pose_estimators/CVPR2020_hand3d/nets/ColorHandPose3DNetwork.py:34-59).
The port's ``models.hand3d`` names its modules after the TF scopes, so the
map is structural:

    <scope>/<layer>/weights|biases -> <scope>.<layer>.conv.weight|bias  (convs)
    <scope>/<layer>/weights|biases -> <scope>.<layer>.weight|bias       (fc_*)

with conv kernels HWIO -> OIHW and dense kernels [in, out] -> [out, in].
Names of no other form are skipped, as the JAX tool skips them; an array
whose shape does not fit its parameter raises, and so does a parameter of
the pipeline that no pickle sets.  The output is
``<checkpoints_dir>/<name>_full/state_latest.pt`` whose ``"module"`` is a
ColorHandPose3D state_dict, the file that ``eval_hand3d --mode full``,
``run_hand3d`` and ``handpose_judge`` read.  The crop size the weights fit
(PosePrior's and ViewpointNet's Linear widths depend on it) comes from the
pickle's own ``PosePrior/fc_rel0/weights``.  Unpickling runs code: convert
only pickles from a source you trust.
"""

from __future__ import annotations

import argparse
import math
import os
import pickle

import numpy as np
import torch

from mmhand_torch.models.hand3d import ColorHandPose3D


def tf_name_to_key(name: str) -> str:
    """'HandSegNet/conv1_1/weights' -> 'HandSegNet.conv1_1.conv.weight';
    'PosePrior/fc_rel0/biases' -> 'PosePrior.fc_rel0.bias'.  KeyError for a
    name that is no layer's weights or biases."""
    parts = name.split("/")
    leaf = {"weights": "weight", "biases": "bias"}.get(parts[-1])
    if leaf is None or len(parts) < 2:
        raise KeyError(f"unrecognized TF variable name: {name}")
    head = parts[:-1]
    conv = [] if head[-1].startswith("fc_") else ["conv"]
    return ".".join(head + conv + [leaf])


def _to_torch_layout(value: np.ndarray) -> np.ndarray:
    if value.ndim == 4:   # HWIO -> OIHW
        return value.transpose(3, 2, 0, 1)
    if value.ndim == 2:   # [in, out] -> [out, in]
        return value.T
    return value


def tf_dict_to_state_dict(weight_dict: dict, template: dict
                          ) -> tuple[dict, list[str], list[str]]:
    """Fill a copy of ``template`` (a state_dict of the port's net) from a
    TF variable dict.  Returns (state_dict, the keys filled, the TF names
    skipped); raises ValueError where an array does not fit its parameter."""
    out = dict(template)
    filled, skipped = [], []
    for name, value in weight_dict.items():
        try:
            key = tf_name_to_key(name)
        except KeyError:
            skipped.append(name)
            continue
        if key not in template:
            skipped.append(name)
            continue
        value = np.asarray(value)
        converted = _to_torch_layout(value)
        if tuple(converted.shape) != tuple(template[key].shape):
            raise ValueError(f"{name}: shape {value.shape} does not fit "
                             f"{key} {tuple(template[key].shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(
            converted, np.float32))
        filled.append(key)
    return out, filled, skipped


def load_pickles(paths) -> dict:
    """The TF variable dicts of ``paths``, merged in order."""
    merged = {}
    for path in paths:
        with open(path, "rb") as f:
            merged.update(pickle.load(f, encoding="latin1"))
    return merged


def crop_size_of(weight_dict: dict) -> int:
    """A crop size whose PosePrior fits the TF dict's ``fc_rel0``: its input
    width is 128 s^2 + 2 for the lifting convs' output side s, which is
    ceil(crop / 64), so crop 64 s (every crop with that s has the same
    state_dict shapes).  The reference's 256 where the dict has no
    PosePrior (the parameters left unset then raise); ValueError where the
    width fits no s."""
    weights = weight_dict.get("PosePrior/fc_rel0/weights")
    if weights is None:
        return 256
    width = np.shape(weights)[0]
    side = int(round(math.sqrt(max(width - 2, 0) / 128)))
    if side < 1 or 128 * side * side + 2 != width:
        raise ValueError(f"PosePrior/fc_rel0/weights: shape "
                         f"{np.shape(weights)} fits no crop size")
    return 64 * side


def convert(pickles, checkpoints_dir: str, name: str) -> dict:
    """Write ``<checkpoints_dir>/<name>_full/state_latest.pt`` from the TF
    pickles; returns a summary (path, counts, missing keys, skipped
    names)."""
    weight_dict = load_pickles(pickles)
    with torch.device("meta"):
        template = ColorHandPose3D(
            crop_size=crop_size_of(weight_dict)).state_dict()
    sd, filled, skipped = tf_dict_to_state_dict(weight_dict, template)
    missing = sorted(set(template) - set(filled))
    if missing:
        raise ValueError(f"the pickles leave {len(missing)} of "
                         f"{len(template)} parameters unset, e.g. "
                         f"{missing[:3]}")
    path = os.path.join(checkpoints_dir, f"{name}_full", "state_latest.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"module": sd}, path)
    return {"path": path, "filled": len(filled), "total": len(template),
            "skipped": skipped}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("pickles", nargs="+",
                   help="TF pickles: handsegnet-rhd.pickle, "
                        "posenet3d-rhd-stb-slr-finetuned.pickle")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--name", default="hand3d")
    args = p.parse_args(argv)
    summary = convert(args.pickles, args.checkpoints_dir, args.name)
    print(f"wrote {summary['path']}: {summary['filled']} tensors from "
          f"{len(args.pickles)} pickle(s), {len(summary['skipped'])} TF names "
          f"skipped")
    return summary


if __name__ == "__main__":
    main()
