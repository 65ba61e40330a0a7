"""The port imports neither JAX nor the JAX package, and its device
default never falls back to the CPU."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import torch
import gsrs_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(gsrs_tpu_torch.__path__, "gsrs_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)  # defines main() but does not run it
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "gsrs_tpu"))
from gsrs_tpu_torch.device import resolve_device
try:
    dev = str(resolve_device())
except RuntimeError as e:
    dev = "raised: " + str(e)
print(json.dumps({"modules": mods, "bad": bad, "cuda": torch.cuda.is_available(),
                  "device": dev, "has_main": callable(smoke.main)}))
"""


def test_port_imports_nothing_of_jax():
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["has_main"]
    for name in ("serve", "convert", "kernels", "drive", "ops.scoring", "ops.ell",
                 "ops.ell_kernel", "ops.spmm", "ops.sampling", "ops.metrics", "models.lightgcn",
                 "data.adjacency", "train.fused_adam", "train.optim", "train.evaluator",
                 "train.trainer", "ops.hybrid", "ops.reorder", "ops.hashdrop", "ops.tiled",
                 "bench", "cli", "__main__", "utils.seeding", "data.i2i", "train.checkpoint",
                 "train.logging", "ops.topk", "data.dataset", "ops.linalg", "models.mf",
                 "models.ngcf", "models.xsimgcl", "models.ultragcn", "models.registry",
                 "data.sequences", "models._transformer", "models.sasrec", "models.gru4rec",
                 "models.bert4rec", "train.seq_trainer", "seq_cli", "serve_seq", "utils.timer",
                 "utils.batching", "data.movielens", "data.instacart", "native",
                 "native.build", "parallel", "parallel.mesh", "parallel.collectives",
                 "parallel.launch", "parallel.sharding", "parallel.dist_train",
                 "parallel.shard_map_train", "parallel.seq_sharding", "parallel.dryrun",
                 "stress_pod", "tools.bench_scaling", "tools.sweep_xsimgcl",
                 "tools.profile_epoch", "tools.bench_scale_standin", "tools.bench_seq_markov"):
        assert f"gsrs_tpu_torch.{name}" in res["modules"]
    if res["cuda"]:
        assert res["device"] == "cuda:0"
    else:
        assert res["device"].startswith("raised:")
