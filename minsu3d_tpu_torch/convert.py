"""JAX PointGroup, HAIS or SoftGroup variables -> the port's ``state_dict``.

Input: the flax variable tree as nested dicts of numpy arrays,
``{"params": {...}, "batch_stats": {...}}`` (how a caller gets it from a
checkpoint is up to the caller; this module imports numpy and torch only).
The port's modules carry the flax module names, so a leaf's key is its
flax path joined with "." and only these layouts change:

* flax ``Dense`` kernels (in, out) -> ``nn.Linear`` weights (out, in), for
  ``Dense_*`` and the named ones (``NAMED_DENSE``);
* ``DenseSubmConv`` kernels and the ScoreNet's (HAIS: TinyUnet's)
  ``conv_kernel`` (D, H, W, Cin, Cout) -> conv3d weights (Cout, Cin, D, H, W);
* the ScoreNet's ``deconv_kernel`` (2, 2, 2, 2c, c) -> a conv_transpose3d
  weight (2c, c, 2, 2, 2), flipped in the three spatial axes;
* sparse conv kernels keep their (27, Cin, Cout) tap order of
  ``ops/sparse.KERNEL_OFFSETS`` and (8, Cin, Cout) child-kid order;
* batch-norm ``batch_stats`` ``mean``/``var`` become buffers of the same name.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


# flax Dense layers that carry a name of their own (PointGroup's and HAIS's
# score branch, HAIS's two-layer mask branch, SoftGroup's mask-scoring,
# classification and IoU-score branches)
NAMED_DENSE = ("score_branch", "mask_branch_0", "mask_branch_1", "mask_scoring_0",
               "mask_scoring_1", "classification_branch", "iou_score")


def _is_dense_kernel(path: tuple) -> bool:
    owner = path[-2] if len(path) > 1 else ""
    return path[-1] == "kernel" and (owner.startswith("Dense_") or owner in NAMED_DENSE)


def convert_leaf(path: tuple, arr: np.ndarray) -> tuple:
    """(state_dict key, torch tensor) of one flax leaf."""
    name = path[-1]
    if _is_dense_kernel(path):
        return ".".join(path[:-1] + ("weight",)), torch.from_numpy(arr.T.copy())
    owner = path[-2] if len(path) > 1 else ""
    if owner.startswith("DenseSubmConv_") or name == "conv_kernel":
        return ".".join(path), torch.from_numpy(arr.transpose(4, 3, 0, 1, 2).copy())
    if name == "deconv_kernel":
        flipped = arr[::-1, ::-1, ::-1]
        return ".".join(path), torch.from_numpy(flipped.transpose(3, 4, 0, 1, 2).copy())
    return ".".join(path), torch.from_numpy(np.array(arr))


def jax_to_state_dict(variables: dict) -> dict:
    """Nested numpy ``{"params", "batch_stats"}`` -> port state_dict."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(coll, {})).items():
            key, t = convert_leaf(path, arr)
            if key in sd:
                raise KeyError(f"two JAX leaves map to {key!r}")
            sd[key] = t.to(torch.float32)
    return sd
