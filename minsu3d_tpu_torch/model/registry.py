"""Model switch of the port, standing in for minsu3d_tpu/model/registry.py:
``get_model(name)`` resolves a model name, in any case ("HAIS" or the
command lines' "hais"), to its bundle of net class, golden eval and
training configs, host-side extraction, losses, epoch gates and the
overrides that open those gates at once."""

from __future__ import annotations

from typing import Callable, NamedTuple


class ModelBundle(NamedTuple):
    net: type                 # (cfg, split) -> nn.Module
    eval_config: type         # the golden eval config of the model
    pred_instances: Callable  # (cfg, scan_id, xyz, out_np, n_ignored) -> list[dict]
    forward_flags: Callable   # (cfg, epoch, train) -> keyword arguments of forward
    losses: Callable          # (cfg, caps, batch, out, with_heads, **loss_flags) -> dict
    loss_flags: Callable      # (cfg, epoch) -> keyword arguments of losses
    train_config: type        # the golden training recipe of the model
    open_gates: dict          # overrides opening the epoch gates from the first heads-on epoch


def _pointgroup() -> ModelBundle:
    from minsu3d_tpu_torch.config import EvalConfig, TrainConfig
    from minsu3d_tpu_torch.model import pointgroup as m

    return ModelBundle(m.PointGroupNet, EvalConfig, m.pred_instances, m.forward_flags,
                       m.losses, m.loss_flags, TrainConfig, {})


def _hais() -> ModelBundle:
    from minsu3d_tpu_torch.config import HaisEvalConfig, HaisTrainConfig
    from minsu3d_tpu_torch.model import hais as m

    return ModelBundle(m.HAISNet, HaisEvalConfig, m.pred_instances, m.forward_flags,
                       m.losses, m.loss_flags, HaisTrainConfig, m.OPEN_GATES)


def _softgroup() -> ModelBundle:
    from minsu3d_tpu_torch.config import SoftGroupEvalConfig, SoftGroupTrainConfig
    from minsu3d_tpu_torch.model import softgroup as m

    return ModelBundle(m.SoftGroupNet, SoftGroupEvalConfig, m.pred_instances, m.forward_flags,
                       m.losses, m.loss_flags, SoftGroupTrainConfig, {})


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
