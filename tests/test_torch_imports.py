"""Import rule of the PyTorch port: ``minsu3d_tpu_torch`` and ``chip_smoke.py``
import only the standard library, numpy, torch and the port itself. Checked
in a fresh interpreter whose import system refuses jax, flax, orbax, yaml,
omegaconf and minsu3d_tpu. Also: the port's stored eval jitter equals what
``jax.random`` draws for the JAX model."""

import os
import subprocess
import sys

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.util, pkgutil, sys

BANNED = ("jax", "jaxlib", "flax", "orbax", "yaml", "omegaconf", "minsu3d_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"banned import: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import minsu3d_tpu_torch
names = ["minsu3d_tpu_torch"]
for mod in pkgutil.walk_packages(minsu3d_tpu_torch.__path__, "minsu3d_tpu_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
assert callable(smoke.main)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print(len(names), "modules")
print(" ".join(names))
"""


def _run_probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


# modules of the training slice, which the probe must have imported too
TRAIN_MODULES = (
    "minsu3d_tpu_torch.train", "minsu3d_tpu_torch.trainer.trainer",
    "minsu3d_tpu_torch.data.datamodule", "minsu3d_tpu_torch.data.transform",
    "minsu3d_tpu_torch.loss.pt_offset_loss", "minsu3d_tpu_torch.ops.instance_iou",
    "minsu3d_tpu_torch.util.lr_decay")


# modules of the SoftGroup slice
SOFTGROUP_MODULES = (
    "minsu3d_tpu_torch.model.softgroup", "minsu3d_tpu_torch.ops.stable_partition",
    "minsu3d_tpu_torch.ops.proposal_rank")


def test_port_imports_no_jax_or_yaml():
    res = _run_probe()
    assert res.returncode == 0, res.stderr[-3000:]
    count, names = res.stdout.splitlines()[:2]
    assert int(count.split()[0]) >= 25, res.stdout
    missing = set(TRAIN_MODULES + SOFTGROUP_MODULES) - set(names.split())
    assert not missing, missing


def test_probe_refuses_banned_import():
    """The probe's guard really refuses: importing the JAX package fails."""
    code = PROBE.split("import minsu3d_tpu_torch")[0] + "import minsu3d_tpu\n"
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and "banned import: minsu3d_tpu" in res.stderr


def test_eval_jitter_matches_jax_random():
    from minsu3d_tpu_torch.model.general_model import EVAL_JITTER

    rng1, rng2 = jax.random.split(jax.random.PRNGKey(0))
    want = (np.asarray(jax.random.uniform(rng1, (3,))),
            np.asarray(jax.random.uniform(rng2, (3,))))
    for stored, drawn in zip(EVAL_JITTER, want):
        np.testing.assert_array_equal(np.asarray(stored, np.float32), drawn)


def test_cluster_variant_modules_and_k14_binding():
    """The clustering variants' functions exist in the port, K14's source is
    one of the kernel library's sources with the entry point that
    ``build.kernel_lib`` binds, and the wrappers refuse a device that is
    neither the CPU nor CUDA (no silent fallback)."""
    import torch

    from minsu3d_tpu_torch.csrc import build
    from minsu3d_tpu_torch.model import general_model
    from minsu3d_tpu_torch.ops import ballquery, cluster

    for mod, names in ((ballquery, ("ball_query", "ball_query_grid", "grid_scan_plain",
                                    "ball_query_grid_scan", "grid_offsets")),
                       (cluster, ("compact_labels", "cluster_points", "cluster_units")),
                       (general_model, ("make_units_grid", "cluster_step"))):
        for name in names:
            assert callable(getattr(mod, name)), name
    src = os.path.join(ROOT, "minsu3d_tpu_torch", "csrc", "ball_query_grid.cu")
    assert src in {str(p) for p in build.kernel_sources()}
    with open(src) as f:
        assert 'extern "C" int ms3d_ball_query_grid(' in f.read()
    with open(build.__file__) as f:
        assert "lib.ms3d_ball_query_grid.argtypes" in f.read()
    assert build.LAUNCHES["ball_query_grid"] == 0
    meta = torch.zeros((4, 3), device="meta")
    flags = torch.ones(4, dtype=torch.bool, device="meta")
    ints = torch.zeros(4, dtype=torch.int32, device="meta")
    for fn in (lambda: ballquery.ball_query_grid(meta, ints, flags, 0.03, 4, 0.03),
               lambda: ballquery.ball_query(meta, ints, flags, 0.03, 4, 4)):
        try:
            fn()
        except (ValueError, NotImplementedError, RuntimeError):
            continue
        raise AssertionError("a wrapper accepted a meta tensor")
