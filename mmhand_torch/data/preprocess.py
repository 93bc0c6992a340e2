"""Offline dataset preprocessing: the RHD and STB crop-tree builders
(counterpart of mmhand_tpu/data/preprocess.py; reference
tool/create_RHD_DB.py:27-403, tool/create_STB_DB.py:18-455).

They write the same on-disk contract, ``annotation.pickle`` beside a PNG
tree, so crop trees built by either package or the reference are
interchangeable.  Host work only: PIL for decode, bilinear resize and
encode, scipy's ``Rotation`` for the projections.  The crops equal
mmhand_tpu's byte for byte.

As mmhand_tpu: the resize is PIL's bilinear (cv2's INTER_LINEAR differs by
at most 1 LSB on smooth images; the packed depth and the label masks are
resized bilinearly too, as in the reference), and the STB images are
written (the reference's writes are commented out,
create_STB_DB.py:308-330).  Unlike mmhand_tpu, an STB image's split comes
with its work item from its sequence, never from its destination path, so a
``dst`` under a folder named ``train`` still files B4 under ``test``.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
from PIL import Image

from mmhand_torch.ops.image import (
    bbox_from_uv,
    flip_uv_x,
    rescale_intrinsics,
    rescale_uv,
)

# RHD keypoint reorder (reference tool/create_RHD_DB.py:195)
RHD_ORDER = [0, 4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9,
             16, 15, 14, 13, 20, 19, 18, 17]
RHD_FRAME = (320, 320)  # (height, width) of an RHD frame

# STB joint remap to the standard ordering (reference create_STB_DB.py:80)
STB_TO_STD = [0, 17, 18, 19, 20, 13, 14, 15, 16, 9, 10, 11, 12,
              5, 6, 7, 8, 1, 2, 3, 4]

# STB camera intrinsics (reference create_STB_DB.py:18-57)
STB_BB_K = np.array([[822.79041, 0.0, 318.47345],
                     [0.0, 822.79041, 250.31296],
                     [0.0, 0.0, 1.0]])
STB_BB_BASE = 120.054
STB_SK_K_COLOR = np.array([[607.92271, 0.0, 314.78337],
                           [0.0, 607.88192, 236.42484],
                           [0.0, 0.0, 1.0]])
STB_SK_K_DEPTH = np.array([[475.62768, 0.0, 336.41179],
                           [0.0, 474.77709, 238.77962],
                           [0.0, 0.0, 1.0]])
STB_SK_R_COLOR = -1 * np.array([0.00531, -0.01196, 0.00301])
STB_SK_T_COLOR = -1 * np.array([-24.0381, -0.4563, -1.2326])

STB_TRAIN_SEQS = ("B1", "B2", "B3", "B5", "B6")  # reference :364-365
STB_TEST_SEQS = ("B4",)


def project_points(xyz, rvec, tvec, k):
    """cv2.projectPoints without distortion: uv = K (R X + T), divided by
    its third row."""
    from scipy.spatial.transform import Rotation

    r = Rotation.from_rotvec(np.asarray(rvec, np.float64).reshape(3))
    pts = r.apply(np.asarray(xyz, np.float64)) + np.asarray(tvec, np.float64)
    proj = pts @ np.asarray(k, np.float64).T
    return proj[:, :2] / proj[:, 2:3]


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    return np.asarray(
        Image.fromarray(img).resize((size, size), Image.BILINEAR))


# ---------------------------------------------------------------------------
# RHD
# ---------------------------------------------------------------------------

def _rhd_process_one(src, file_idx, anno, size):
    """Crop one RHD frame's hand or hands (reference create_RHD_DB.py:
    198-298).  A frame with 42 keypoints is split into its left (``_l``,
    the first 21) and right (``_r``) hands; the right hand's crop is
    mirrored.  A hand with an invisible keypoint is rejected.  Returns a
    list of (file tag, cropped annotation, {kind: image})."""
    matrix = np.array(anno["K"])
    xyz = np.asarray(anno["xyz"])
    uv_vis = np.asarray(anno["uv_vis"])

    if xyz.shape[0] > 21:  # two hands in the frame
        out = []
        for tag, sl in [("l", slice(0, 21)), ("r", slice(21, None))]:
            sub = dict(anno)
            sub["xyz"] = xyz[sl]
            sub["uv_vis"] = uv_vis[sl]
            out += _rhd_process_one(src, f"{file_idx}_{tag}", sub, size)
        return out

    xyz = xyz[:21][RHD_ORDER]
    coor = uv_vis[:21][RHD_ORDER].astype(np.float64)
    if coor[:, -1].sum() != 21:  # an invisible keypoint
        return []

    xmin, xmax, ymin, ymax = bbox_from_uv(coor[:, :2], RHD_FRAME)
    if xmin > xmax or ymin > ymax:
        return []
    uv = rescale_uv(coor[:, :2], xmin, ymin, xmax, ymax, size)
    matrix = rescale_intrinsics(matrix, xmin, ymin, xmax, ymax, size)

    flip = file_idx.endswith("_r")
    name = f"{int(file_idx.split('_')[0]):05d}.png"

    images = {}
    for kind in ("color", "depth", "mask"):
        img = np.asarray(Image.open(os.path.join(src, kind, name)))
        img = _resize(img[ymin:ymax + 1, xmin:xmax + 1], size)
        images[kind] = img[:, ::-1] if flip else img
    if flip:
        uv = flip_uv_x(uv, size)

    cropped = {"K": matrix, "uv_coord": uv[:, :2], "xyz": xyz,
               "depth": xyz[:, -1]}
    return [(file_idx, cropped, images)]


def create_rhd_db(src: str, dst: str, size: int = 256,
                  split: str = "evaluation", workers: int = 8,
                  limit: Optional[int] = None) -> int:
    """Build the RHD crop tree (reference create_RHD_DB.py:306-355).

    ``src`` holds ``<split>/anno_<split>.pickle`` and
    ``<split>/{color,depth,mask}/NNNNN.png``.  Writes
    ``dst/{color,depth,mask}/NNNNN.png``, numbered anew from 0 in frame
    order, and ``dst/annotation.pickle``; a crop whose mask holds no hand
    (its maximum 0 or 1) is dropped.  Returns the number of crops."""
    path = os.path.join(src, split)
    with open(os.path.join(path, f"anno_{split}.pickle"), "rb") as f:
        anno = pickle.load(f)

    for kind in ("color", "depth", "mask"):
        os.makedirs(os.path.join(dst, kind), exist_ok=True)

    keys = sorted(anno.keys()) if isinstance(anno, dict) else range(len(anno))
    if limit:
        keys = list(keys)[:limit]

    def work(i):
        return _rhd_process_one(path, f"{i}", anno[i], size)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        results = [r for rs in ex.map(work, keys) for r in rs]

    cropped_annos: dict = {}
    count = 0
    for _tag, cropped, images in results:
        # the false-positive filter (reference :336-343)
        if images["mask"].max() in (0, 1):
            continue
        new_name = f"{count:05d}.png"
        for kind in ("color", "depth", "mask"):
            Image.fromarray(images[kind]).save(
                os.path.join(dst, kind, new_name))
            cropped_annos.setdefault(kind, {})[new_name] = cropped
        count += 1

    with open(os.path.join(dst, "annotation.pickle"), "wb") as f:
        pickle.dump(cropped_annos, f)
    return count


# ---------------------------------------------------------------------------
# STB
# ---------------------------------------------------------------------------

def stb_xyz_from_mat(path: str) -> np.ndarray:
    """(1500, 21, 3) xyz in mm from an STB label .mat
    (reference create_STB_DB.py:141-158)."""
    from scipy.io import loadmat

    labels = loadmat(path)["handPara"]  # (3, 21, 1500)
    return np.transpose(labels, (2, 1, 0)).astype(np.float64)


def stb_uv_coord(mode: str, camera: str, xyz: np.ndarray) -> np.ndarray:
    """STB xyz projected to pixels (reference create_STB_DB.py:161-186)."""
    zero = np.zeros(3)
    if camera == "SK":
        if mode == "color":
            return project_points(xyz, STB_SK_R_COLOR, STB_SK_T_COLOR,
                                  STB_SK_K_COLOR)
        if mode == "depth":
            return project_points(xyz, zero, zero, STB_SK_K_DEPTH)
    elif camera == "BB":
        if mode == "left":
            return project_points(xyz, zero, zero, STB_BB_K)
        if mode == "right":
            return project_points(xyz, zero,
                                  np.array([-STB_BB_BASE, 0.0, 0.0]), STB_BB_K)
    raise ValueError(f"bad camera/mode {camera}/{mode}")


def _stb_k_for(camera: str, mode: str) -> np.ndarray:
    """The camera matrix filed with a crop.  A reference quirk, kept
    (create_STB_DB.py:312-317): an SK 'color' image takes K_depth, any
    other SK image K_color."""
    if camera == "BB":
        return STB_BB_K.copy()
    return (STB_SK_K_DEPTH if mode == "color" else STB_SK_K_COLOR).copy()


def _stb_process_one(img_path, destination, xyz, size):
    """reference create_STB_DB.py:297-331, with the image written."""
    camera, mode, _idx = os.path.basename(img_path).split("_")
    depth = xyz[:, -1].copy()
    uv = stb_uv_coord(mode, camera, xyz)
    image = np.asarray(Image.open(img_path).convert("RGB"))
    xmin, xmax, ymin, ymax = bbox_from_uv(uv, image.shape[:2])
    k = _stb_k_for(camera, mode)
    uv2 = rescale_uv(uv, xmin, ymin, xmax, ymax, size)
    k2 = rescale_intrinsics(k, xmin, ymin, xmax, ymax, size)
    crop = _resize(image[ymin:ymax + 1, xmin:xmax + 1], size)
    os.makedirs(os.path.dirname(destination), exist_ok=True)
    Image.fromarray(crop).save(destination)
    return uv2, depth, xyz, k2


def create_stb_db(src: str, dst: str, size: int = 256, workers: int = 8,
                  limit: Optional[int] = None) -> dict:
    """Build the STB train and test crop trees (reference
    create_STB_DB.py:334-419).

    ``src`` is an STB root with ``labels/<seq>_<camera>.mat`` and one image
    folder per sequence.  B1, B2, B3, B5 and B6 go to ``dst/train``, B4 to
    ``dst/test``, each with its ``annotation.pickle``.  Returns the counts,
    {"train": n, "test": m}."""
    dsts = {"train": os.path.join(dst, "train"),
            "test": os.path.join(dst, "test")}
    labels_dir = os.path.join(src, "labels")
    items = []  # (split, folder, image name, work arguments)
    for mat in sorted(os.listdir(labels_dir)):
        folder = mat.split("_")[0]
        camera = mat.split("_")[-1][:-4]
        xyz_all = stb_xyz_from_mat(os.path.join(labels_dir, mat))
        img_dir = os.path.join(src, folder)
        images = [i for i in sorted(os.listdir(img_dir))
                  if i.split("_")[0] == camera]
        if limit:
            images = images[:limit]
        split = "train" if folder[:2] in STB_TRAIN_SEQS else "test"
        for img in images:
            index = int(img.rsplit("_", 1)[-1][:-4])
            items.append((split, folder, img, (
                os.path.join(img_dir, img),
                os.path.join(dsts[split], folder, img),
                xyz_all[index][STB_TO_STD], size)))

    with ThreadPoolExecutor(max_workers=workers) as ex:
        results = list(ex.map(lambda it: _stb_process_one(*it[3]), items))

    annos = {"train": {}, "test": {}}
    for (split, folder, image, _), (uv, depth, xyz, k) in zip(items, results):
        annos[split].setdefault(folder, {})[image] = {
            "uv_coord": uv, "k": k, "depth": depth, "xyz": xyz}

    counts = {}
    for split, base in dsts.items():
        os.makedirs(base, exist_ok=True)
        with open(os.path.join(base, "annotation.pickle"), "wb") as f:
            pickle.dump(annos[split], f)
        counts[split] = sum(len(v) for v in annos[split].values())
    return counts
