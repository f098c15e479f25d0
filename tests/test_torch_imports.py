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


def test_port_imports_no_jax_or_yaml():
    res = _run_probe()
    assert res.returncode == 0, res.stderr[-3000:]
    count, names = res.stdout.splitlines()[:2]
    assert int(count.split()[0]) >= 25, res.stdout
    missing = set(TRAIN_MODULES) - set(names.split())
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
