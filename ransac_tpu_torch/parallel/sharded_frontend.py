"""Keyframe-axis sharded front end over a [F, H, W] frame stack (port of
``ransac_tpu.parallel.sharded_frontend``).

Each rank of the mesh's ``data`` axis takes its contiguous block of F / n
frames: Harris detection and patch descriptors as one batch over the
block, and consecutive-pair mutual-NN matching as one batched matmul.  The
one dependency across ranks, a block's last frame matched against the next
block's first, arrives by one right-neighbour hop of that frame's
descriptors and validity (``parallel.mesh.from_right``, JAX's
``ppermute``); the last rank's neighbour is all invalid, so row F-1 of the
match arrays is too.  The outputs are gathered over ``data`` into the
global [F, ...] arrays, in frame order, on every rank, so the host track
chaining and the SfM consume them unchanged.  A mesh of one is the same
code with the hop's zero block and no collective.

``matches_to_tracks`` chains the matches into the SfM track table on the
host (numpy, the JAX function's code).
"""

from __future__ import annotations

import numpy as np
import torch

from ransac_tpu_torch.features.detect import detect_harris
from ransac_tpu_torch.features.match import mutual_nn_match, patch_descriptors
from ransac_tpu_torch.parallel import mesh as mesh_mod
from ransac_tpu_torch.utils.config import TwoViewConfig


def frontend_frames(images: torch.Tensor, max_kp: int = 512, nms_radius: int = 4,
                    harris_k: float = 0.04, patch: int = 8):
    """Batched detect + describe over a [F, H, W] frame stack, on the
    stack's device.  Returns ``(xy [F, K, 2], valid [F, K], desc [F, K,
    patch^2])`` with fixed shapes (slots masked by ``valid``)."""
    images = images.to(torch.float32)
    kp = detect_harris(images, max_kp, nms_radius, harris_k)
    return kp.xy, kp.valid, patch_descriptors(images, kp.xy, kp.valid, patch)


def match_consecutive(xy, valid, desc, ratio: float = 0.9):
    """Mutual-NN match frame f against f+1 for all consecutive pairs, as one
    batched call.  Returns ``(idx2 [F-1, K], mvalid [F-1, K])``: match slot
    k of pair f maps keypoint k of frame f to keypoint ``idx2[f, k]`` of
    frame f+1."""
    m = mutual_nn_match(desc[:-1], desc[1:], valid[:-1], valid[1:], ratio)
    return m.idx2, m.valid


def distributed_frontend(images, mesh: mesh_mod.Mesh,
                         cfg: TwoViewConfig = TwoViewConfig()):
    """The front end sharded over the mesh's ``data`` axis, called by every
    rank of the mesh with the same ``images`` ([F, H, W] array or tensor, F
    divisible by the data axis).

    Returns on every rank ``(xy [F, K, 2], valid [F, K], desc [F, K, D],
    idx2 [F, K], mvalid [F, K])`` on its device: rows 0..F-2 of the match
    arrays are the consecutive pairs (row f matches frame f to f+1); row F-1
    matches the last frame against the missing right neighbour and is all
    invalid."""
    n_data = mesh.shape["data"]
    F = images.shape[0]
    if F % n_data:
        raise ValueError(f"{F} frames do not split over data = {n_data}")
    images = torch.as_tensor(images, dtype=torch.float32)
    local = mesh_mod.block(mesh, images, "data").to(mesh.device)
    xy, valid, desc = frontend_frames(local, cfg.max_keypoints, cfg.nms_radius,
                                      cfg.harris_k, cfg.patch_size)
    # The right neighbour's first frame, to this rank (left shift).
    d2 = torch.cat([desc[1:], mesh_mod.from_right(mesh, desc[:1], "data")])
    v2 = torch.cat([valid[1:], mesh_mod.from_right(mesh, valid[:1], "data")])
    m = mutual_nn_match(desc, d2, valid, v2, cfg.match_ratio)
    return tuple(mesh_mod.all_gather(mesh, a, "data").flatten(0, 1)
                 for a in (xy, valid, desc, m.idx2, m.valid))


def matches_to_tracks(xy, idx2, mvalid, min_len: int = 2) -> dict:
    """Chain consecutive-pair matches into SfM tracks.

    ``xy [F, K, 2]``, ``idx2 [P, K]``, ``mvalid [P, K]`` with P >= F-1
    (extra rows ignored; arrays or tensors).  Returns ``{(frame, track_id):
    uv ndarray[2]}``, the input of ``pipelines.sfm.incremental_sfm``,
    keeping tracks observed in at least ``min_len`` frames.  One numpy step
    a frame carries the track labels of frame f's matched keypoints to
    their targets in frame f+1; unlabeled matched keypoints open new tracks
    in ascending-k order, and of duplicate targets the lowest k wins."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    xy = host(xy)
    idx2 = host(idx2)
    mvalid = host(mvalid).astype(bool)
    F, K = xy.shape[:2]
    label = np.full((F, K), -1, np.int64)
    next_tid = 0
    for f in range(min(F - 1, len(mvalid))):
        ks = np.nonzero(mvalid[f])[0]
        if ks.size == 0:
            continue
        tgt = idx2[f, ks]
        _, first = np.unique(tgt, return_index=True)
        ks = ks[np.sort(first)]
        tgt = idx2[f, ks]
        lab = label[f, ks]
        new = lab < 0
        n_new = int(new.sum())
        lab[new] = next_tid + np.arange(n_new)
        next_tid += n_new
        label[f, ks] = lab
        label[f + 1, tgt] = lab
    fs, kk = np.nonzero(label >= 0)
    tids = label[fs, kk]
    counts = np.bincount(tids, minlength=max(next_tid, 1))
    sel = counts[tids] >= min_len
    uvs = xy[fs, kk].astype(np.float64)
    return {(int(f), int(t)): uv for f, t, uv in zip(fs[sel], tids[sel], uvs[sel])}
