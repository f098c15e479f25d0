"""Model switch of the port, standing in for minsu3d_tpu/model/registry.py:
``get_model(name)`` resolves a model name, in any case ("HAIS" or the
command lines' "hais"), to its bundle of net class, golden eval config,
host-side extraction and epoch gates."""

from __future__ import annotations

from typing import Callable, NamedTuple


class ModelBundle(NamedTuple):
    net: type                 # (cfg, split) -> nn.Module
    eval_config: type         # the golden eval config of the model
    pred_instances: Callable  # (cfg, scan_id, xyz, out_np, n_ignored) -> list[dict]
    forward_flags: Callable   # (cfg, epoch, train) -> keyword arguments of forward


def _pointgroup() -> ModelBundle:
    from minsu3d_tpu_torch.config import EvalConfig
    from minsu3d_tpu_torch.model import pointgroup as m

    return ModelBundle(m.PointGroupNet, EvalConfig, m.pred_instances, m.forward_flags)


def _hais() -> ModelBundle:
    from minsu3d_tpu_torch.config import HaisEvalConfig
    from minsu3d_tpu_torch.model import hais as m

    return ModelBundle(m.HAISNet, HaisEvalConfig, m.pred_instances, m.forward_flags)


def _softgroup() -> ModelBundle:
    from minsu3d_tpu_torch.config import SoftGroupEvalConfig
    from minsu3d_tpu_torch.model import softgroup as m

    return ModelBundle(m.SoftGroupNet, SoftGroupEvalConfig, m.pred_instances, m.forward_flags)


MODELS = {"PointGroup": _pointgroup, "HAIS": _hais, "SoftGroup": _softgroup}
NOT_PORTED: tuple = ()
CLI_NAMES = sorted(n.lower() for n in MODELS)   # --model choices of the entry points


def get_model(name: str) -> ModelBundle:
    name = {n.lower(): n for n in (*MODELS, *NOT_PORTED)}.get(name.lower(), name)
    if name in NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet (have {sorted(MODELS)})")
    if name not in MODELS:
        raise KeyError(f"Unknown model {name!r} (have {sorted(MODELS)})")
    return MODELS[name]()
